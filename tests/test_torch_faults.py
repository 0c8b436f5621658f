"""Fault injection of the port (``theanompi_tpu_torch/utils/faults.py``)
against the reference's (``theanompi_tpu/utils/faults.py``), on the CPU:
the same spec strings parse to the same fields or fail alike, a scripted
run of steps fires the same faults in the same order, the fired-fault
ledger holds once-only across injectors (and across ranks), and every
storage mutation leaves files on which both packages' integrity checks
agree."""

import errno
import os
import shutil

import numpy as np
import pytest

import jax.numpy as jnp

from theanompi_tpu.utils import checkpoint as jckpt
from theanompi_tpu.utils import faults as jfaults
from theanompi_tpu_torch.utils import checkpoint as tckpt
from theanompi_tpu_torch.utils import faults as tfaults

import torch

VALID = ["crash@5", "sigterm@1", "sigkill@7", "loader_stall@3:0.5", "shrink@3:2", "grow@2:4",
         "slice_down@3", "slice_down@3:2", "enospc@2:1024", "slow_write@4:0.25", "bitrot@4",
         "partial_set@2", "ckpt_truncate@6", "nan_batch@9"]
INVALID = ["crash", "boom@3", "crash@x", "crash@0", "shrink@3", "shrink@3:1.5", "grow@2:0",
           "slice_down@3:0", "crash@3:abc"]


@pytest.mark.parametrize("spec", VALID)
def test_valid_specs_parse_to_the_reference_fields(spec):
    t, j = tfaults.parse_fault_spec(spec), jfaults.parse_fault_spec(spec)
    assert (t.kind, t.step, t.arg, t.fired) == (j.kind, j.step, j.arg, j.fired)


@pytest.mark.parametrize("spec", INVALID)
def test_invalid_specs_fail_in_both_packages(spec):
    with pytest.raises(ValueError):
        jfaults.parse_fault_spec(spec)
    with pytest.raises(ValueError):
        tfaults.parse_fault_spec(spec)


SCRIPT = ["loader_stall@2:0", "crash@3", "nan_batch@4", "ckpt_truncate@4", "shrink@5:2",
          "enospc@5", "grow@6:3", "bitrot@6", "slow_write@7:0", "partial_set@8",
          "slice_down@10", "crash@9"]


def _events(pkg, zeros):
    """What an injector of ``pkg`` does over steps 1..10 of a scripted
    run: each fault it fires, the world it leaves, the batch it poisons,
    its write faults and storage mutations (saves at every even step)."""
    inj = pkg.FaultInjector(SCRIPT)
    inj.set_topology(2, 2)
    out = []
    for step in range(1, 11):
        try:
            inj.check_step(step)
            out.append(("ok", step))
        except pkg.InjectedCrash:
            out.append(("crash", step))
        except pkg.TopologyChanged as e:
            out.append(("topology", e.kind, e.step, e.new_world))
        x = inj.poison_batch(zeros(), step)
        out.append(("poisoned", bool(np.isnan(np.asarray(x)).any())))
        out.append(("world", inj.world_override()))
        if step % 2 == 0:
            out.append(("write", inj.write_fault(step)))
            out.append(("mutate", [s.kind for s in inj.storage_mutations_due(step)]))
    out.append(("fired", [(s.kind, s.step, s.fired_seq) for s in inj.specs]))
    return out


def test_a_scripted_run_fires_the_reference_sequence():
    ours = _events(tfaults, lambda: torch.zeros(2))
    ref = _events(jfaults, lambda: jnp.zeros(2))
    assert ours == ref
    assert ("topology", "slice_down", 10, 2) in ours and ("crash", 3) in ours


def test_the_ledger_holds_once_across_injectors_and_ranks(tmp_path):
    ledger = str(tmp_path / "ledger")
    # both ranks of an attempt arm at its start and fire the same spec
    ranks = [tfaults.FaultInjector(["crash@3"], ledger=ledger, rank=r) for r in (0, 1)]
    for inj in ranks:
        with pytest.raises(tfaults.InjectedCrash):
            inj.check_step(3)
    assert open(ledger).read().splitlines() == ["crash@3", "crash@3 rank=1"]
    # a relaunch, of either package: the fault already happened once
    for pkg in (tfaults, jfaults):
        copy = str(tmp_path / f"ledger-{pkg.__name__}")
        shutil.copy(ledger, copy)
        again = pkg.FaultInjector(["crash@3"], ledger=copy)
        again.check_step(3)
        assert again.specs[0].fired
        two = pkg.FaultInjector(["crash@3", "crash@3"], ledger=copy)
        assert [s.fired for s in two.specs] == [True, False]
        with pytest.raises(pkg.InjectedCrash):
            two.check_step(3)


def _flat(step):
    g = np.random.default_rng(step)
    return {".params/w": g.standard_normal((64, 32)).astype(np.float32),
            ".step": np.asarray(step, np.int32)}


def _set(d, step):
    flat = _flat(step)
    for r in range(2):
        rows = flat[".params/w"][32 * r:32 * (r + 1)]
        tckpt.save_checkpoint_sharded(
            d, {".params/w": ((64, 32), [([[32 * r, 32 * (r + 1)], [0, 32]], rows)])},
            step, r, 2, keep=10)


@pytest.mark.parametrize("kind", ["ckpt_truncate", "bitrot", "partial_set", "enospc"])
def test_storage_faults_leave_files_both_packages_judge_alike(tmp_path, kind):
    d = str(tmp_path)
    tckpt.save_checkpoint(d, _flat(1), 1, keep=10)
    _set(d, 2)
    tckpt.save_checkpoint(d, _flat(3), 3, keep=10)
    inj = tfaults.FaultInjector([f"{kind}@3"])
    if kind == "enospc":
        tckpt.set_write_fault_hook(inj.write_fault)
        try:
            with pytest.raises(OSError) as e:
                tckpt.save_checkpoint(d, _flat(4), 4, keep=10)
            assert e.value.errno == errno.ENOSPC
        finally:
            tckpt.set_write_fault_hook(None)
        hit = None
    else:
        if kind == "partial_set":
            os.unlink(os.path.join(d, "ckpt_3.npz"))
        (spec,) = inj.storage_mutations_due(3)
        hit = inj.apply_storage_mutation(spec, d)
        assert hit is not None
    names = sorted(os.listdir(d))
    assert not [n for n in names if n.endswith(".tmp")] and "ckpt_4.npz" not in names
    verdicts = {n: tckpt.verify_checkpoint(os.path.join(d, n)) for n in names}
    assert verdicts == {n: jckpt.verify_checkpoint(os.path.join(d, n)) for n in names}
    if hit is not None:
        assert not verdicts[os.path.basename(hit) if kind != "partial_set" else
                            "ckpt_2.proc0of2.npz"]
    newest = tckpt.latest_checkpoint(d, verify=True)
    assert newest == jckpt.latest_checkpoint(d, verify=True)
    want = {"ckpt_truncate": "ckpt_2.proc0of2.npz", "bitrot": "ckpt_2.proc0of2.npz",
            "partial_set": "ckpt_1.npz", "enospc": "ckpt_3.npz"}[kind]
    assert os.path.basename(newest) == want
