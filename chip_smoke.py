#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``theanompi_tpu_torch``) on one card.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit and no result line):

1. build   — compile every kernel of the path (``csrc/*.cu``) with nvcc
             for sm_90a; print the build's wall time.
2. kernels — each kernel's wrapper against its plain PyTorch version at
             AlexNet's 16 parameter-leaf shapes: momentum, Nesterov and
             sgd; fp32 params with fp32 grads, bf16 params with bf16 and
             with fp32 grads; conv leaves in the default layout and in
             channels_last (the main path's); clip off / norm under /
             norm over the limit. Tolerance: fp32 params and every fp32
             velocity bit-identical; bf16 params within 1 bf16 ulp.
             Launch counters must move by one per leaf.
3. main    — the training path a user runs, through
             ``theanompi_tpu_torch.cli.main``: full-width AlexNet (batch
             128, 227x227x3, 1000 classes, bf16 compute, fp32 params,
             random weights from a seed) for 10 steps with
             ``--fused-update`` (momentum recipe), then 3 steps of the
             same model under an sgd recipe. Counters are zeroed just
             before each run and read just after: the momentum run must
             launch the momentum kernel 16 x steps times, the sgd run the
             sgd kernel 16 x steps times. Every loss must be finite.
4. parity  — the same small AlexNet (67x67, fp32, dropout off) trained 2
             steps on the card and on the CPU (where the wrappers run
             their plain versions) from the same weights and batches.
             Losses agree within rtol 1e-3. Each leaf's velocity agrees
             within rtol 1e-3 plus 2e-3 of its largest value: cuDNN's
             fp32 weight gradient of conv2 at this geometry is off by
             about 8e-4 of its largest value against float64
             (``tools/conv_precision.py --size 67``), the CPU's by 1e-6.
             So does its parameter change (after - before), plus 2 fp32
             ulps of the parameter: a change far smaller than the
             parameter is rounded at each of the 2 writes. Every leaf
             changed on the card.
5. times   — per kernel: time per launch and per optimizer step (all 16
             leaves, CUDA events), its bound (bytes / memory rate vs
             operations / fp32 peak, the larger), the plain version's time,
             and a PyTorch yardstick: ``torch.optim.SGD(fused=True)``.

Then one JSON line ``{"kernels": [...]}``, the card's name and power
limit as nvidia-smi prints them, and last ``{"ok": true, "device": ...}``.
Exits 2 without a card, or when run outside a checkout of the repo.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# card name -> (memory rate B/s, fp32 peak outside the tensor cores FLOP/s),
# from NVIDIA's data sheet: the H100 SXM5 80 GB. Another card has other
# rates, so the script refuses it rather than compute its bounds wrongly.
CARD_RATES = {"NVIDIA H100 80GB HBM3": (3.35e12, 67e12)}

MAIN_STEPS = 10
SGD_STEPS = 3
FULL_WIDTH = ["--dataset-arg", "image_shape=[227,227,3]", "--dataset-arg", "n_classes=1000"]


class Failed(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise Failed(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


class Tee(io.TextIOBase):
    def __init__(self, *streams):
        self.streams = streams

    def write(self, s):
        for st in self.streams:
            st.write(s)
        return len(s)

    def flush(self):
        for st in self.streams:
            st.flush()


def run_cli(argv):
    """``theanompi_tpu_torch.cli.main(argv)``; returns its summary (the
    last stdout line), echoing the run's output."""
    from theanompi_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(Tee(sys.stdout, buf)):
        rc = cli.main(argv)
    check(rc == 0, f"cli.main returned {rc}")
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def ulp_distance_bf16(a, b):
    """Max distance in bf16 units in the last place (sign-aware)."""
    import torch

    def key(t):
        bits = t.view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)

    return int((key(a) - key(b)).abs().max().item())


def alexnet_leaf_shapes():
    import torch
    from theanompi_tpu_torch.models.alex_net import AlexNet
    from theanompi_tpu_torch.tree import tree_leaves

    model = AlexNet()
    params, _ = model.net.init(torch.Generator().manual_seed(0), model.input_shape)
    return [tuple(p.shape) for p in tree_leaves(params)]


def phase_kernels(shapes, dev):
    """Kernel against plain version at the main path's leaf shapes."""
    import torch
    from theanompi_tpu_torch.ops import fused_update as fu

    gen = torch.Generator(device=dev).manual_seed(0)
    worst = {"fused_momentum": 0.0, "fused_sgd": 0.0}
    worst_ulp = 0
    cases = [(pd, gd, layout)
             for pd, gd in ((torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
                            (torch.bfloat16, torch.float32))
             for layout in (torch.contiguous_format, torch.channels_last)]
    for dtype, gdtype, layout in cases:
        def leaf(s, scale, dt):
            t = (torch.randn(s, generator=gen, device=dev) * scale).to(dt)
            return t.contiguous(memory_format=layout) if len(s) == 4 else t

        ps = [leaf(s, 0.01, dtype) for s in shapes]
        vs = [leaf(s, 1e-3, torch.float32) for s in shapes]
        gs = [leaf(s, 1e-2, gdtype) for s in shapes]
        case = f"p {str(dtype)[6:]} g {str(gdtype)[6:]} {str(layout)[6:]}"
        norm = float(torch.sqrt(sum(torch.sum(g.float() ** 2) for g in gs)).item())
        for clip_name, clip in (("off", None), ("under", norm * 10.0), ("over", norm / 3.0)):
            coef = fu.clip_coefficient(gs, clip)
            if clip_name == "over":
                check(abs(coef.item() - 1 / 3.0) < 1e-4, f"clip coefficient {coef.item()}")
            else:
                check(coef.item() == 1.0, f"clip coefficient {coef.item()} with norm under the limit")
            sc = fu.scalars(torch.full((), 0.01, device=dev), coef, dev)
            for variant in ("momentum", "nesterov", "sgd"):
                counter = fu.SGD if variant == "sgd" else fu.MOMENTUM
                counter.reset()
                err, ulp = 0.0, 0
                for p, v, g in zip(ps, vs, gs):
                    pk, pp = p.clone(), p.clone()
                    vk, vp = v.clone(), v.clone()
                    if variant == "sgd":
                        fu.fused_sgd_leaf(pk, g, sc, weight_decay=5e-4)
                        fu.fused_sgd_leaf_plain(pp, g, sc, weight_decay=5e-4)
                    else:
                        kw = dict(momentum=0.9, weight_decay=5e-4, nesterov=variant == "nesterov")
                        fu.fused_update_leaf(pk, vk, g, sc, **kw)
                        fu.fused_update_leaf_plain(pp, vp, g, sc, **kw)
                        check(torch.equal(vk, vp), f"{variant} velocity differs ({case}, clip {clip_name})")
                    err = max(err, (pk.float() - pp.float()).abs().max().item())
                    if dtype == torch.float32:
                        check(torch.equal(pk, pp),
                              f"{variant} fp32 params not bit-identical ({case}, clip {clip_name}): "
                              f"max abs err {err}")
                    else:
                        ulp = max(ulp, ulp_distance_bf16(pk, pp))
                check(ulp <= 1, f"{variant} bf16 params differ by {ulp} ulp ({case}, clip {clip_name})")
                check(counter.launches == len(shapes),
                      f"{counter.name} counter moved {counter.launches}, expected {len(shapes)}")
                name = "fused_sgd" if variant == "sgd" else "fused_momentum"
                worst[name] = max(worst[name], err)
                worst_ulp = max(worst_ulp, ulp)
                print(f"  {variant:9s} {case:40s} clip {clip_name:5s}: max abs err {err:.3g}, "
                      f"bf16 ulp {ulp}, launches {counter.launches}", flush=True)
        del ps, vs, gs
    torch.cuda.synchronize()
    return worst, worst_ulp


def phase_main():
    """The user's training path through the CLI, counters zeroed just
    before each run and read just after."""
    from theanompi_tpu_torch.ops import fused_update as fu

    runs = {}
    for name, counter, other, steps, extra in (
        ("fused_momentum", fu.MOMENTUM, fu.SGD, MAIN_STEPS,
         ["--dataset-arg", f"n_train={128 * MAIN_STEPS}", "--dataset-arg", "n_val=128"]),
        ("fused_sgd", fu.SGD, fu.MOMENTUM, SGD_STEPS,
         ["--dataset-arg", f"n_train={128 * SGD_STEPS}", "--dataset-arg", "n_val=128",
          "--recipe-arg", "optimizer=sgd",
          "--recipe-arg", 'opt_kwargs={"weight_decay": 0.0005}']),
    ):
        argv = ["BSP", "1", "alexnet", "AlexNet", "--synthetic", "--fused-update",
                "--max-steps", str(steps), "--print-freq", "1", "--seed", "0",
                *FULL_WIDTH, *extra]
        print(f"[main] python -m theanompi_tpu_torch.cli {' '.join(argv)}", flush=True)
        fu.MOMENTUM.reset()
        fu.SGD.reset()
        summary = run_cli(argv)
        launches, stray = counter.launches, other.launches
        check(summary["steps"] == steps, f"{name} run took {summary['steps']} steps, expected {steps}")
        losses = summary["losses"]
        check(len(losses) == steps and all(math.isfinite(x) for x in losses)
              and summary["nonfinite_steps"] == 0, f"{name} run: non-finite loss in {losses}")
        check(launches == 16 * steps, f"{name} launched {launches} times, expected {16 * steps}")
        check(stray == 0, f"{other.name} launched {stray} times in the {name} run")
        check("val" in summary and all(math.isfinite(v) for v in summary["val"].values()),
              f"{name} run: bad val metrics {summary.get('val')}")
        print(f"[main] {name}: per-step loss {losses}", flush=True)
        print(f"[main] {name}: steady-state step {summary['step_ms']:.3f} ms over "
              f"{summary['steady_steps']} steps (CUDA events, 2 warm-up steps excluded), "
              f"{summary['images_per_sec']:.1f} img/s, launches {launches}", flush=True)
        runs[name] = {"launches": launches, "summary": summary}
    return runs


def phase_parity(dev):
    """Small AlexNet: 2 steps on the card vs 2 steps on the CPU."""
    import torch
    from theanompi_tpu_torch.models.alex_net import AlexNet
    from theanompi_tpu_torch.train import init_train_state, make_train_step
    from theanompi_tpu_torch.tree import tree_leaves

    recipe = AlexNet.default_recipe().replace(
        input_shape=(67, 67, 3), num_classes=10, batch_size=8, compute_dtype=torch.float32,
        sched_kwargs={"lr": 0.001, "boundaries": [30, 50, 65], "factor": 0.1})
    model = AlexNet(recipe)
    for layer in model.net.layers:
        if hasattr(layer, "rate"):
            layer.rate = 0.0
    rng = torch.Generator().manual_seed(3)
    xs = [torch.randn(8, 67, 67, 3, generator=rng) for _ in range(2)]
    ys = [torch.randint(0, 10, (8,), generator=rng) for _ in range(2)]
    out = {}
    for d in ("cpu", dev):
        state = init_train_state(model, torch.Generator().manual_seed(7), d)
        before = [p.detach().cpu().clone() for p in tree_leaves(state.params)]
        step = make_train_step(model, fused_update=True)
        losses = []
        for x, y in zip(xs, ys):
            state, m = step(state, x.to(d), y.to(d), None)
            losses.append(float(m["loss"]))
        after = [p.detach().cpu() for p in tree_leaves(state.params)]
        vels = [v.detach().cpu() for v in tree_leaves(state.opt_state["vel"])]
        out[str(d)] = (losses, [a - b for a, b in zip(after, before)], vels, after)
    (lc, dc, vc, pc), (lg, dg, vg, _) = out["cpu"], out[str(dev)]
    check(all(math.isclose(a, b, rel_tol=1e-3) for a, b in zip(lc, lg)),
          f"card losses {lg} vs CPU {lc}")
    worst = {"parameter change": 0.0, "velocity": 0.0}
    for what, cpu, card in (("parameter change", dc, dg), ("velocity", vc, vg)):
        for i, (a, b) in enumerate(zip(cpu, card)):
            scale = a.abs().max().item()
            check(scale > 0 and b.abs().max().item() > 0, f"leaf {i}: no {what} on the card or CPU")
            slack = 1e-3 * a.abs()
            if what == "parameter change":
                p = pc[i].abs()
                slack = slack + 2 * (torch.nextafter(p, torch.full_like(p, math.inf)) - p)
            err = ((a - b).abs() - slack).max().item() / scale
            worst[what] = max(worst[what], err)
            check(err <= 2e-3, f"leaf {i}: card {what} differs from CPU by {err:.3g} of its "
                               "largest value beyond the slack (limit 2e-3)")
    print(f"[parity] losses card {lg} vs CPU {lc}; worst excess over the slack, as a share of "
          f"each leaf's largest value (limit 2e-3): {worst}", flush=True)


def phase_times(shapes, dev, mem_rate, fp32_peak):
    """Per-launch and per-step times of each kernel vs bound, plain, library."""
    import torch
    from theanompi_tpu_torch.ops import fused_update as fu

    gen = torch.Generator(device=dev).manual_seed(1)
    ps = [torch.randn(s, generator=gen, device=dev) * 0.01 for s in shapes]
    vs = [torch.randn(s, generator=gen, device=dev) * 1e-3 for s in shapes]
    gs = [torch.randn(s, generator=gen, device=dev) * 1e-2 for s in shapes]
    sc = fu.scalars(torch.full((), 0.01, device=dev), fu.clip_coefficient(gs, None), dev)
    n_total = sum(p.numel() for p in ps)
    kw = dict(momentum=0.9, weight_decay=5e-4, nesterov=False)
    results = {}
    specs = {
        # name: (kernel leaf fn, plain leaf fn, bytes/elem, ops/elem, library optimizer kwargs)
        "fused_momentum": (
            lambda i: fu.fused_update_leaf(ps[i], vs[i], gs[i], sc, **kw),
            lambda i: fu.fused_update_leaf_plain(ps[i], vs[i], gs[i], sc, **kw),
            20, 7, dict(momentum=0.9, weight_decay=5e-4),
        ),
        "fused_sgd": (
            lambda i: fu.fused_sgd_leaf(ps[i], gs[i], sc, weight_decay=5e-4),
            lambda i: fu.fused_sgd_leaf_plain(ps[i], gs[i], sc, weight_decay=5e-4),
            12, 5, dict(momentum=0.0, weight_decay=5e-4),
        ),
    }
    with torch.no_grad():
        for name, (kern, plain, bpe, ope, lib_kw) in specs.items():
            per_leaf = [cuda_ms(lambda i=i: kern(i), reps=20) for i in range(len(ps))]
            step_ms = cuda_ms(lambda: [kern(i) for i in range(len(ps))], reps=20)
            plain_ms = cuda_ms(lambda: [plain(i) for i in range(len(ps))], reps=5)
            byts = n_total * bpe + 8 * len(ps)  # + the 2-float scalar block per launch
            ops = n_total * ope
            bytes_ms = byts / mem_rate * 1e3
            ops_ms = ops / fp32_peak * 1e3
            bound_ms = max(bytes_ms, ops_ms)
            leaves = [torch.nn.Parameter(p.clone()) for p in ps]
            for leaf, g in zip(leaves, gs):
                leaf.grad = g.clone()
            opt = torch.optim.SGD(leaves, lr=0.01, fused=True, **lib_kw)
            lib_ms = cuda_ms(opt.step, reps=20)
            del opt, leaves
            results[name] = dict(step_ms=step_ms, per_leaf_ms=per_leaf, plain_ms=plain_ms,
                                 bound_ms=bound_ms, bytes=byts, ops=ops,
                                 bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                                 library_ms=lib_ms)
            print(f"[times] {name}: {step_ms:.4f} ms/step (16 launches) | bound {bound_ms:.4f} ms "
                  f"({byts / 1e9:.4f} GB at {mem_rate / 1e12:.2f} TB/s; {results[name]['bound_by']}) "
                  f"| {bound_ms / step_ms * 100:.1f}% of bound | plain {plain_ms:.4f} ms "
                  f"| torch.optim.SGD(fused=True, {lib_kw}) {lib_ms:.4f} ms", flush=True)
            for s, t in zip(shapes, per_leaf):
                n = math.prod(s)
                print(f"[times]   {name} leaf {str(s):22s} {t * 1e3:9.2f} us/launch "
                      f"(bound {n * bpe / mem_rate * 1e6:8.2f} us)", flush=True)
    torch.cuda.synchronize()
    return results


def main() -> int:
    t_start = time.perf_counter()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "theanompi_tpu_torch")):
        print("chip_smoke: theanompi_tpu_torch/ not found beside this script; run it "
              "from a checkout of the repo", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, cuda {torch.version.cuda}",
          flush=True)
    try:
        smi = nvidia_smi_line()
        kind = torch.cuda.get_device_name(0)
        check(kind in CARD_RATES, f"no data-sheet rates for {kind!r} (known: {sorted(CARD_RATES)}); "
                                  "add the card's memory rate and fp32 peak to CARD_RATES")
        mem_rate, fp32_peak = CARD_RATES[kind]
        print(f"card: {smi} | {kind} | memory rate for bounds {mem_rate / 1e12:.2f} TB/s", flush=True)
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)

        from theanompi_tpu_torch.ops import fused_update as fu
        from theanompi_tpu_torch.ops.kernels import library_path

        t0 = time.perf_counter()
        build_s = fu.build()
        print(f"[build] csrc/fused_update.cu -> {library_path('fused_update.cu').name}: "
              f"nvcc {build_s:.2f} s (phase wall {time.perf_counter() - t0:.2f} s)", flush=True)

        shapes = alexnet_leaf_shapes()
        check(len(shapes) == 16 and sum(math.prod(s) for s in shapes) == 60_965_224,
              f"unexpected AlexNet leaves {shapes}")
        t0 = time.perf_counter()
        worst, worst_ulp = phase_kernels(shapes, dev)
        print(f"[kernels] all cases match ({time.perf_counter() - t0:.1f} s)", flush=True)

        t0 = time.perf_counter()
        runs = phase_main()
        print(f"[main] done ({time.perf_counter() - t0:.1f} s)", flush=True)

        t0 = time.perf_counter()
        phase_parity(dev)
        print(f"[parity] done ({time.perf_counter() - t0:.1f} s)", flush=True)

        t0 = time.perf_counter()
        times = phase_times(shapes, dev, mem_rate, fp32_peak)
        print(f"[times] done ({time.perf_counter() - t0:.1f} s)", flush=True)
        torch.cuda.synchronize()
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    src = "theanompi_tpu_torch/csrc/fused_update.cu"
    replaces = {
        "fused_momentum": "theanompi_tpu/ops/pallas_update.py:78",
        "fused_sgd": "theanompi_tpu/ops/pallas_update.py:90",
    }
    kernels = []
    for name in ("fused_momentum", "fused_sgd"):
        t = times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces[name],
            "launches": runs[name]["launches"], "max_abs_err": worst[name],
            "ms": t["step_ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "matched": True,
            "tolerance": "fp32 params and velocity bit-identical; bf16 params <= 1 ulp "
                         f"(worst seen {worst_ulp})",
            "work": "one optimizer step over AlexNet's 16 fp32 leaves (60,965,224 params)",
            "ms_per_launch": t["per_leaf_ms"],
            "library_note": (
                "torch.optim.SGD(momentum=0.9, weight_decay=5e-4, fused=True).step(): "
                "same class of rule, velocity parametrised differently (v=mu*v+g; p-=lr*v)"
                if name == "fused_momentum" else
                "torch.optim.SGD(momentum=0, weight_decay=5e-4, fused=True).step(): same function"
            ),
            "main_path_step_ms": runs[name]["summary"]["step_ms"],
            "main_path_images_per_sec": runs[name]["summary"]["images_per_sec"],
        })
    print(f"chip_smoke: wall {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
