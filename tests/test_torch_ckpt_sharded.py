"""Per-rank sharded checkpoint sets (``--ckpt-sharded``) across the two
packages, on the CPU with the small AlexNet of
``tests/test_torch_resume.py`` and gloo ranks:

- a 2-rank BSP ``int8:ef`` set written by the port holds the state the
  gathered single file holds, entry for entry, and the reference's
  ``load_checkpoint`` reassembles it to the same arrays; so for an
  EASGD set (its ``.workers`` stacks a row a rank);
- a set the reference writes (a leaf cut into 8 pieces over its mesh)
  loads in the port;
- a set missing a member is absent to both packages;
- the reference's ``read_topology_manifest`` reads the port's manifest,
  and both packages' ``verify_checkpoint`` agree on every member.
"""

import os
import pathlib
import shutil
import tempfile

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from theanompi_tpu.utils import checkpoint as jckpt
from theanompi_tpu_torch.launch.session import launch_training
from theanompi_tpu_torch.utils import checkpoint as tckpt

SMALL = dict(input_shape=(67, 67, 3), num_classes=10, batch_size=4)
DATA = {"n_train": 12, "n_val": 4}


def nested(flat: dict) -> dict:
    """A tree of nested dicts whose tree paths are ``flat``'s keys (the
    reference's ``_path_key`` joins dict keys with ``/``): a template the
    reference's readers take."""
    root: dict = {}
    for k, v in flat.items():
        *head, leaf = k.split("/")
        d = root
        for p in head:
            d = d.setdefault(p, {})
        d[leaf] = v
    return root


def flatten(tree, prefix="") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: np.asarray(tree)}


def state_only(flat):
    return {k: v for k, v in flat.items() if not k.startswith("__")}


@pytest.fixture(scope="module")
def runs():
    """2-rank runs of 2 steps: BSP int8:ef sharded and gathered, EASGD
    sharded (``{label: ckpt_dir}``)."""
    root = pathlib.Path(tempfile.mkdtemp(prefix="tmpi-sharded-"))
    env = pytest.MonkeyPatch()
    env.setenv("OMP_NUM_THREADS", "1")  # the rank processes' intra-op threads
    common = dict(device="cpu", fused_update=True, dataset="synthetic", n_epochs=1, recipe_overrides=dict(compute_dtype="float32", **SMALL),
                  max_steps=2, print_freq=0)
    try:
        out = {}
        for label, rule, kw in (("bsp-sharded", "bsp", dict(ckpt_sharded=True)),
                                ("bsp-gathered", "bsp", {}),
                                ("easgd-sharded", "easgd", dict(ckpt_sharded=True, avg_freq=1))):
            # EASGD's global batch is its 2 workers' batches of 4
            extra = (dict(strategy="psum", wire_codec="int8:ef", dataset_kwargs=DATA)
                     if rule == "bsp" else dict(dataset_kwargs={"n_train": 16, "n_val": 8}))
            launch_training(rule, 2, "alexnet", "AlexNet", ckpt_dir=str(root / label),
                            **common, **extra, **kw)
            out[label] = root / label
        yield out
    finally:
        env.undo()
        shutil.rmtree(root, ignore_errors=True)


def test_a_bsp_set_holds_the_gathered_state_and_loads_in_the_reference(runs):
    d = runs["bsp-sharded"]
    assert sorted(os.listdir(d)) == ["ckpt_2.proc0of2.npz", "ckpt_2.proc1of2.npz"]
    member = tckpt.latest_checkpoint(str(d), verify=True)
    ours = tckpt.load_checkpoint(member)
    gathered = tckpt.load_checkpoint(str(runs["bsp-gathered"] / "ckpt_2.npz"))
    assert sorted(ours) == sorted(gathered)
    for k in ours:  # residual rows and generator rows included
        np.testing.assert_array_equal(ours[k], gathered[k], err_msg=k)
    assert ours[".ef/10_conv4/w"].shape == (2, 3, 3, 192, 384)
    template = nested({k: np.zeros_like(v) for k, v in state_only(ours).items()})
    ref, rng = jckpt.load_checkpoint(member, template)
    assert rng is None
    ref = flatten(ref)
    assert sorted(ref) == sorted(state_only(ours))
    for k, v in ref.items():
        np.testing.assert_array_equal(v, ours[k], err_msg=k)


def test_an_easgd_set_loads_in_the_reference(runs):
    member = tckpt.latest_checkpoint(str(runs["easgd-sharded"]), verify=True)
    ours = tckpt.load_checkpoint(member)
    assert ours[".workers/.params/00_conv1/w"].shape[0] == 2
    assert ours[".workers/.step"].tolist() == [2, 2]
    ref, _ = jckpt.load_checkpoint(member, nested(
        {k: np.zeros_like(v) for k, v in state_only(ours).items()}))
    for k, v in flatten(ref).items():
        np.testing.assert_array_equal(v, ours[k], err_msg=k)
    # rank 0 alone holds the center; each rank its worker's rows
    with np.load(member.replace("proc0of2", "proc1of2")) as f:
        assert not [n for n in f.files if n.startswith(".center")]
        assert any(n.startswith(".workers/") for n in f.files)


def test_a_reference_set_loads_in_the_port(tmp_path):
    mesh = Mesh(np.array(jax.devices()), ("data",))
    w = np.arange(8 * 6, dtype=np.float32).reshape(8, 6)
    state = {".params": {"w": jax.device_put(jnp.asarray(w),
                                             NamedSharding(mesh, PartitionSpec("data")))},
             ".step": jnp.asarray(5, jnp.int32)}
    path = jckpt.save_checkpoint_sharded(str(tmp_path), state, 5, topology={
        "mesh": {"shape": [8], "axes": ["data"]}, "elastic": {}})
    assert os.path.basename(path) == "ckpt_5.proc0of1.npz"
    with np.load(path) as f:
        assert len([n for n in f.files if n.startswith(".params/w::s")]) == 8
    assert tckpt.latest_checkpoint(str(tmp_path), verify=True) == path
    flat = tckpt.load_checkpoint(path)
    np.testing.assert_array_equal(flat[".params/w"], w)
    assert int(flat[".step"]) == 5
    assert tckpt.read_topology_manifest(path)["mesh"] == {"shape": [8], "axes": ["data"]}


def test_a_set_missing_a_member_is_absent_to_both(runs, tmp_path):
    src = runs["bsp-sharded"]
    for f in os.listdir(src):
        shutil.copy(src / f, tmp_path / f)
    shutil.copy(runs["bsp-gathered"] / "ckpt_2.npz", tmp_path / "ckpt_1.npz")
    os.unlink(tmp_path / "ckpt_2.proc1of2.npz")
    for pkg in (tckpt, jckpt):
        assert pkg._sharded_sets(str(tmp_path)) == {}
        assert pkg.latest_checkpoint(str(tmp_path)) == str(tmp_path / "ckpt_1.npz")
        assert not pkg.verify_checkpoint(str(tmp_path / "ckpt_2.proc0of2.npz"))


def test_the_reference_reads_the_port_manifest_and_agrees_on_integrity(runs, tmp_path):
    member = tckpt.latest_checkpoint(str(runs["bsp-sharded"]))
    ours = tckpt.read_topology_manifest(member)
    assert jckpt.read_topology_manifest(member) == ours
    assert ours["version"] == jckpt.TOPOLOGY_VERSION
    assert ours["mesh"] == {"shape": [2], "axes": ["data"]}
    assert ours["elastic"] == {"policies": {".ef": {"policy": "reset"}}, "base_world": 2}
    state = state_only(tckpt.load_checkpoint(member))
    assert sorted(ours["leaves"]) == sorted(state)
    assert ours["leaves"][".ef/10_conv4/w"]["spec"] == [["data"]]
    assert ours["leaves"][".params/10_conv4/w"]["spec"] is None
    gathered = str(runs["bsp-gathered"] / "ckpt_2.npz")
    assert jckpt.read_topology_manifest(gathered) == ours
    for f in sorted(os.listdir(runs["bsp-sharded"])):
        shutil.copy(runs["bsp-sharded"] / f, tmp_path / f)
    paths = [str(tmp_path / f) for f in sorted(os.listdir(tmp_path))]
    assert [tckpt.verify_checkpoint(p) for p in paths] == [True, True]
    assert [jckpt.verify_checkpoint(p) for p in paths] == [True, True]
    with open(paths[1], "r+b") as f:  # rank 1's member rots: the whole set fails
        f.seek(os.path.getsize(paths[1]) // 2)
        f.write(b"\xff" * 8)
    assert [tckpt.verify_checkpoint(p) for p in paths] == [False, False]
    assert [jckpt.verify_checkpoint(p) for p in paths] == [False, False]
