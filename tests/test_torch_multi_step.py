"""Step fusion in the port: ``train.make_multi_step``, grouped training
loops (``--steps-per-dispatch``), the graph runner's host-side rules, the
FLOP count and the compute-mode benchmark, on the CPU.

1. ``make_multi_step`` with k = 3, stacked and unstacked, equals 3
   sequential port steps bit for bit (dropout on: the generator draws
   the same masks in the same order), and, dropout off, the reference's
   ``make_multi_step`` (JAX, CPU) from the same weights and batches at
   ``tests/test_fused_dispatch.py``'s tolerances: losses rtol 1e-5,
   params and velocities atol 3e-5.
2. ``run_training(steps_per_dispatch=3, max_steps=7)`` equals the
   per-step run bit for bit: the final params and velocities, every
   recorder row but its times, the ``max_steps`` checkpoint, with a
   trimmed last group, groups cut by an epoch's end, and a resume from a
   mid-epoch checkpoint.
3. ``graphs.py``'s rules that need no card: the launch counters' deltas,
   the state-identity check, the in-place write-back, the capture
   error's site; the refusal of several ranks with groups on the card
   (an argument check).
4. ``utils/flops.py`` counts AlexNet's products within 1% of a count
   from the layer shapes; ``tools/bench.py --device cpu`` prints a valid
   last line.

The card's side (capture, replay, registered generator, counters under
replay) is held by ``chip_smoke.py``'s phase graph.
"""

import json
import math
import pathlib
import shutil
import tempfile

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from theanompi_tpu import nn as jnn
from theanompi_tpu.models.alex_net import AlexNet as JAlexNet
from theanompi_tpu.train import init_train_state as j_init_state
from theanompi_tpu.train import make_multi_step as j_make_multi_step
from theanompi_tpu.train import make_train_step as j_train_step
from theanompi_tpu_torch import bridge, graphs
from theanompi_tpu_torch import nn as tnn
from theanompi_tpu_torch.launch.worker import run_training
from theanompi_tpu_torch.models.alex_net import AlexNet as TAlexNet
from theanompi_tpu_torch.ops import kernels
from theanompi_tpu_torch.parallel.bsp import check_fused_ranks
from theanompi_tpu_torch.train import TrainState
from theanompi_tpu_torch.train import init_train_state as t_init_state
from theanompi_tpu_torch.train import _optimizer_for, make_multi_step, make_train_step
from theanompi_tpu_torch.tree import tree_leaves
from theanompi_tpu_torch.utils import checkpoint as tckpt
from theanompi_tpu_torch.utils.flops import CostModel, count_step_flops, peak_flops

BATCH = 4
SMALL = dict(input_shape=(67, 67, 3), num_classes=10, batch_size=BATCH)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: runs held bit for bit against each other take
    no order of a parallel reduction from the machine's load."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture
def scratch():
    """A directory removed when the test ends (checkpoints of ~100 MB)."""
    d = tempfile.mkdtemp(prefix="tmpi-test-")
    try:
        yield pathlib.Path(d)
    finally:
        shutil.rmtree(d, ignore_errors=True)


class JAlexNetNoDropout(JAlexNet):
    def build(self):
        net = super().build()
        for layer in net.layers:
            if isinstance(layer, jnn.Dropout):
                layer.rate = 0.0
        return net


class TAlexNetNoDropout(TAlexNet):
    def build(self):
        net = super().build()
        for layer in net.layers:
            if isinstance(layer, tnn.Dropout):
                layer.rate = 0.0
        return net


def _batches(n, seed=0):
    r = np.random.RandomState(seed)
    return [(r.randn(BATCH, 67, 67, 3).astype(np.float32),
             r.randint(0, 10, BATCH).astype(np.int32)) for _ in range(n)]


def _port_state(model, seed=0):
    return t_init_state(model, torch.Generator().manual_seed(seed), "cpu")


def _assert_states_equal(a, b):
    la, lb = tree_leaves((a.params, a.opt_state, a.step)), tree_leaves((b.params, b.opt_state,
                                                                         b.step))
    assert len(la) == len(lb)
    for i, (x, y) in enumerate(zip(la, lb)):
        assert torch.equal(x, y), f"state leaf {i} differs"


# --------------------------------------------------------------------------
# 1. make_multi_step
# --------------------------------------------------------------------------


@pytest.mark.parametrize("stacked", [True, False], ids=["stacked", "unstacked"])
def test_multi_step_equals_sequential_steps_bit_for_bit(stacked):
    """Full AlexNet layers at 67x67, dropout on, the fused update's plain
    route: k = 3 in one call against 3 calls of the step."""
    model = TAlexNet(TAlexNet.default_recipe().replace(compute_dtype=torch.float32, **SMALL))
    step = make_train_step(model, fused_update=True)
    batches = [(torch.from_numpy(x), torch.from_numpy(y)) for x, y in _batches(3)]
    if not stacked:
        batches = [batches[0]] * 3
    ref = t_init_state(model, torch.Generator().manual_seed(0), "cpu",
                       optimizer=_optimizer_for(model, True))
    gen = torch.Generator().manual_seed(7)
    ref_metrics = []
    for x, y in batches:
        ref, m = step(ref, x, y, gen)
        ref_metrics.append(m)
    ref_gen = gen.get_state()

    state = t_init_state(model, torch.Generator().manual_seed(0), "cpu",
                         optimizer=_optimizer_for(model, True))
    gen = torch.Generator().manual_seed(7)
    run = make_multi_step(step, 3, stacked=stacked, device="cpu")
    assert run.graph is None
    if stacked:
        xs = torch.stack([x for x, _ in batches])
        ys = torch.stack([y for _, y in batches])
    else:
        xs, ys = batches[0]
    marks = []
    state, metrics = run(state, xs, ys, gen, after_step=lambda: marks.append(1))
    assert len(marks) == 3
    assert sorted(metrics) == sorted(ref_metrics[0])
    for key, col in metrics.items():
        assert col.dtype == torch.float32 and col.shape == (3,)
        want = torch.stack([m[key].float().reshape(()) for m in ref_metrics])
        assert torch.equal(col, want), key
    _assert_states_equal(state, ref)
    assert torch.equal(gen.get_state(), ref_gen)  # the same masks were drawn
    assert int(state.step) == 3


def test_multi_step_refuses_a_wrong_group():
    model = TAlexNetNoDropout(TAlexNet.default_recipe().replace(**SMALL))
    run = make_multi_step(make_train_step(model), 3, stacked=True, device="cpu")
    x, y = torch.zeros(2, BATCH, 67, 67, 3), torch.zeros(2, BATCH, dtype=torch.int32)
    with pytest.raises(ValueError, match="expects 3 batches"):
        run(None, x, y, None)
    with pytest.raises(ValueError, match="k must be >= 1"):
        make_multi_step(make_train_step(model), 0, device="cpu")


@pytest.mark.parametrize("stacked,fused", [(True, True), (False, False)],
                         ids=["stacked-fused", "unstacked-plain"])
def test_multi_step_matches_the_reference(stacked, fused):
    """fp32 compute, dropout off: the port's and the reference's
    ``make_multi_step`` over the same 3 steps from the same weights."""
    jm = JAlexNetNoDropout(JAlexNet.default_recipe().replace(compute_dtype=jnp.float32, **SMALL))
    tm = TAlexNetNoDropout(TAlexNet.default_recipe().replace(compute_dtype=torch.float32,
                                                             **SMALL))
    jstate = j_init_state(jm, jax.random.PRNGKey(0))
    tstate = _port_state(tm)
    tstate = TrainState(
        bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params)), {},
        bridge.opt_state_from_jax(jax.tree_util.tree_map(np.asarray, jstate.opt_state)),
        tstate.step)
    batches = _batches(3)
    xs = np.stack([x for x, _ in batches])
    ys = np.stack([y for _, y in batches])
    if not stacked:
        xs, ys = xs[0], ys[0]
    jrun = jax.jit(j_make_multi_step(j_train_step(jm, fused_update=fused), 3, stacked=stacked))
    jstate, jm_ = jrun(jstate, jnp.asarray(xs), jnp.asarray(ys), jax.random.PRNGKey(1))
    trun = make_multi_step(make_train_step(tm, fused_update=fused), 3, stacked=stacked,
                           device="cpu")
    tstate, tm_ = trun(tstate, torch.from_numpy(xs), torch.from_numpy(ys), None)
    np.testing.assert_allclose(tm_["loss"].numpy(), np.asarray(jm_["loss"]), rtol=1e-5)
    np.testing.assert_allclose(tm_["lr"].numpy(), np.asarray(jm_["lr"]), rtol=1e-7)
    assert int(tstate.step) == int(jstate.step) == 3
    for got, ref in ((bridge.params_to_jax(tstate.params), jstate.params),
                     (bridge.opt_state_to_jax(tstate.opt_state), jstate.opt_state)):
        for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(ref)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=3e-5)


# --------------------------------------------------------------------------
# 2. grouped training loops
# --------------------------------------------------------------------------

# 20 images of a batch of 4: 5 steps an epoch
DATA = {"n_train": 20, "n_val": 4}


def _run(save_dir, ckpt_dir, max_steps, k, **kw):
    return run_training(model_cls=TAlexNet, device="cpu", fused_update=True,
                        dataset="synthetic", dataset_kwargs=DATA, n_epochs=3,
                        recipe_overrides=dict(compute_dtype=torch.float32, **SMALL),
                        max_steps=max_steps, ckpt_dir=str(ckpt_dir), save_dir=str(save_dir),
                        print_freq=2, steps_per_dispatch=k, async_checkpoint=False, **kw)


def _rows(save_dir):
    """The recorder's rows without their times."""
    rows = [json.loads(line) for line in open(save_dir / "alexnet_bsp.jsonl")]
    return [{k: v for k, v in r.items() if k not in ("images_per_sec", "seconds")}
            for r in rows]


def _entries(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files if k not in tckpt.META_KEYS}


def _assert_files_equal(a, b):
    ea, eb = _entries(a), _entries(b)
    assert sorted(ea) == sorted(eb)
    for k in ea:
        np.testing.assert_array_equal(ea[k], eb[k], err_msg=k)


def test_grouped_run_equals_the_per_step_run_bit_for_bit(scratch):
    """7 steps of 5 an epoch: groups 3, 2 | 2 (the epoch cuts the second,
    max_steps the third); then 3 grouped steps and a grouped resume to 7
    (the first resumed group is the epoch's 2 remaining batches)."""
    one = _run(scratch / "l1", scratch / "c1", 7, 1)
    three = _run(scratch / "l3", scratch / "c3", 7, 3)
    assert one["steps"] == three["steps"] == 7 == three["device_steps"]
    assert one["steps_per_dispatch"] == 1 and three["steps_per_dispatch"] == 3
    assert one["captured"] is False and three["captured"] is False  # no graph on the CPU
    assert three["losses"] == one["losses"]
    assert three["replica_digest_per_rank"] == one["replica_digest_per_rank"]
    assert three["val"] == one["val"]
    assert _rows(scratch / "l3") == _rows(scratch / "l1")
    assert [c["step"] for c in three["checkpoints"]] == [c["step"] for c in one["checkpoints"]] \
        == [5, 7]
    _assert_files_equal(three["checkpoints"][-1]["path"], one["checkpoints"][-1]["path"])
    assert len(three["epoch_step_ms"]) == len(one["epoch_step_ms"]) == 2

    cut = _run(scratch / "lr", scratch / "cr", 3, 3)
    resumed = _run(scratch / "lr2", scratch / "cr", 7, 3, resume=True)
    assert resumed["resumed_from_step"] == 3 and resumed["steps"] == 7
    assert cut["losses"] + resumed["losses"] == one["losses"]
    assert resumed["replica_digest_per_rank"] == one["replica_digest_per_rank"]
    _assert_files_equal(resumed["checkpoints"][-1]["path"], one["checkpoints"][-1]["path"])


def test_grouped_steps_refuse_bad_arguments():
    with pytest.raises(ValueError, match="steps_per_dispatch must be >= 1"):
        run_training(model_cls=TAlexNet, device="cpu", steps_per_dispatch=0)
    with pytest.raises(ValueError, match="accum_steps must be >= 1"):
        run_training(model_cls=TAlexNet, device="cpu", accum_steps=0)


# --------------------------------------------------------------------------
# 3. the graph runner's host-side rules
# --------------------------------------------------------------------------


def test_several_ranks_with_groups_on_the_card_are_refused():
    """Several gloo ranks on the card are refused (gloo's CUDA
    collectives cannot be captured); NCCL ranks capture their exchange."""
    card = torch.device("cuda", 0)  # an argument check: no card needed
    with pytest.raises(ValueError, match="gloo's collectives of CUDA tensors"):
        check_fused_ranks(2, 4, card, "gloo")
    with pytest.raises(ValueError, match="gloo's collectives of CUDA tensors"):
        check_fused_ranks(4, 2, "cuda:1", "gloo")
    check_fused_ranks(4, 2, card, "nccl")  # NCCL ranks group
    check_fused_ranks(1, 4, card)  # one rank groups
    check_fused_ranks(2, 1, card, "gloo")  # ranks step one at a time
    check_fused_ranks(2, 4, "cpu", "gloo")  # the CPU groups eagerly


def test_launch_counts_take_back_and_add_deltas():
    before = kernels.launch_counts()
    name = sorted(before)[0] if before else None
    if name is None:
        kernels.LaunchCounter("test_multi_step_counter")
        before = kernels.launch_counts()
        name = "test_multi_step_counter"
    after = dict(before, **{name: before[name] + 3})
    delta = graphs.count_delta(before, after)
    assert delta == {name: 3}
    kernels.add_launch_counts(delta)
    assert kernels.launch_counts()[name] == before[name] + 3
    kernels.add_launch_counts({k: -n for k, n in delta.items()})
    assert kernels.launch_counts() == before
    assert graphs.count_delta(before, before) == {}


def test_state_identity_and_write_back():
    a, b = torch.zeros(3), torch.ones(2)
    assert graphs.same_leaves([a, b], [a, b])
    assert not graphs.same_leaves([a, b], [a, b.clone()])  # equal values, another tensor
    assert not graphs.same_leaves([a, b], [a])
    old = [torch.zeros(3), torch.zeros((), dtype=torch.int32), b]
    new = [torch.arange(3.0), torch.tensor(5, dtype=torch.int32), b]  # b updated in place
    keep = [t for t in old]
    graphs.write_back(old, new)
    assert all(x is y for x, y in zip(old, keep))
    assert torch.equal(old[0], torch.arange(3.0)) and int(old[1]) == 5
    with pytest.raises(graphs.GraphCaptureError, match="in place"):
        graphs.write_back([torch.zeros(3)], [torch.zeros(4)])
    with pytest.raises(graphs.GraphCaptureError, match="structure"):
        graphs.write_back([torch.zeros(3)], [])


def test_capture_error_names_the_ports_frame():
    from theanompi_tpu_torch.ops import lr_schedules

    try:
        lr_schedules.get_schedule("no-such-schedule")
    except ValueError as e:
        site = graphs.capture_site(e)
    assert site.startswith("theanompi_tpu_torch/ops/lr_schedules.py:") and "get_schedule" in site


def test_a_step_graph_needs_a_card():
    with pytest.raises(ValueError, match="CUDA device"):
        graphs.StepGraph(lambda *a: a, "cpu")


def test_metrics_columns_are_fp32_rows_of_one_buffer():
    m = {"loss": torch.tensor(2.5), "lr": torch.tensor(0.01, dtype=torch.bfloat16),
         "error": torch.tensor(0.25, dtype=torch.float64)}
    keys = sorted(m)
    row = graphs.metric_row(m, keys)
    assert row.dtype == torch.float32 and row.tolist() == [0.25, 2.5,
                                                           float(torch.tensor(0.01).bfloat16())]
    rows = torch.stack([row, row * 2])
    cols = graphs.as_columns(rows, keys)
    assert cols["loss"].tolist() == [2.5, 5.0] and cols["loss"].data_ptr() == rows[:, 1].data_ptr()


# --------------------------------------------------------------------------
# 4. FLOPs and the benchmark
# --------------------------------------------------------------------------


def _shape_flops(model, batch):
    """AlexNet's products in one train step from its layer shapes: each
    conv 2·N·Ho·Wo·Cout·(Cin/g)·kh·kw forward, as much again for its
    weight gradient and for its input gradient (none for the first
    conv, whose input needs none); each LRN's banded [C, C] matmul
    forward and its input gradient; each dense layer 2·N·in·out, times 3."""
    shape = (batch, *model.recipe.input_shape)
    total = 0
    first = True
    for layer in model.net.layers:
        out = layer.out_shape(shape)
        if isinstance(layer, tnn.Conv):
            kh, kw = layer.kernel
            f = 2 * math.prod(out) * (shape[-1] // layer.groups) * kh * kw
            total += f * (2 if first else 3)
            first = False
        elif isinstance(layer, tnn.LRN):
            f = 2 * math.prod(shape[:-1]) * shape[-1] ** 2
            total += 2 * f
        elif isinstance(layer, tnn.Dense):
            total += 3 * 2 * batch * shape[-1] * layer.out_features
        shape = out
    return total


def test_flop_count_matches_alexnets_layer_shapes():
    model = TAlexNet(TAlexNet.default_recipe().replace(**SMALL))
    state = _port_state(model)
    x, y = (torch.from_numpy(a) for a in _batches(1)[0])
    (state, _), flops = count_step_flops(make_train_step(model), state, x, y,
                                         torch.Generator().manual_seed(0))
    want = _shape_flops(model, BATCH)
    assert int(state.step) == 1  # the counted step ran
    assert abs(flops - want) <= 0.01 * want, (flops, want)
    assert peak_flops("cpu") is None
    cost = CostModel(flops, 1e12)
    assert cost.mfu(flops / 0.5e12) == pytest.approx(0.5)
    assert cost.mfu(None) is None and CostModel(flops).mfu(1.0) is None
    assert cost.min_step_seconds() == pytest.approx(flops / 1e12)


@pytest.mark.parametrize("model,extra", [
    ("alexnet", ["--fused-update", "--recipe-arg", "batch_size=4",
                 "--recipe-arg", "input_shape=[67,67,3]", "--recipe-arg", "num_classes=10"]),
    ("lm_136m", ["--recipe-arg", "batch_size=2", "--recipe-arg", "input_shape=[64]",
                 "--recipe-arg", "num_classes=32", "--recipe-arg", "d_model=32",
                 "--recipe-arg", "n_heads=2", "--recipe-arg", "n_layers=2",
                 "--recipe-arg", "d_ff=64"]),
])
def test_bench_prints_a_valid_last_line_on_the_cpu(model, extra, capsys):
    from theanompi_tpu_torch.tools import bench

    assert bench.main(["--model", model, "--device", "cpu", "--steps", "2", "--trials", "2",
                       *extra]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["metric"].startswith(f"{model}_") and out["metric"].endswith("_cpu")
    assert out["value"] > 0 and out["timing"]["k"] == 2 and out["timing"]["median_s"] > 0
    assert out["mfu"] is None and out["captured"] is False
    assert out["device_kind"] == "cpu" and out["power_limit_w"] is None
    assert out["flops_per_step"] > 0 and len(out["last_losses"]) == 2
    assert all(math.isfinite(v) for v in out["last_losses"])
    if model == "lm_136m":
        assert out["unit"] == "sequences/sec"
        assert out["tokens_per_sec"] == pytest.approx(out["value"] * 64)
    else:
        assert out["unit"] == "images/sec"
