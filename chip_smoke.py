#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``fedml_tpu_torch``) on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It needs one CUDA card, ``nvcc`` and ``nvidia-smi``; without a card it
exits non-zero and prints no result.  Phases, one line each; any failure
raises and ends the run with a non-zero exit:

1. device — the card's name and power limit as ``nvidia-smi`` reports them;
2. build — every CUDA kernel of the main path, compiled from
   ``fedml_tpu_torch/csrc`` (one ``nvcc`` per source, started together);
3. kernels — each kernel against its plain PyTorch version on the card, on
   the unit-test cases and at the main path's shape, with the tolerance;
4. timing — at the main path's shape, each kernel, its plain version and
   one PyTorch library call, beside the least time the card could take;
5. parity — one round of the port on the card against the same round on
   the CPU (the CPU path is held to the JAX package by the tests);
6. main path — the north-star config of ``bench.py`` (Parrot FedAvg,
   ResNet-56 at full width in bfloat16, 100 clients split Dirichlet(0.5),
   10 per round in 10 size strata capped at 0.8, batch 32, lr 0.05) for 3
   rounds on the 50k/10k hard synthetic CIFAR-10 stand-in, through
   ``init → device → data → model → FedMLRunner(...).run()``, with the
   kernels' launch counts set to 0 just before and read just after;
7. trace — one client of the main path's round under ``torch.profiler``:
   the device's busy share of its wall time, the kernels launched per
   batch and the ones that take the device time.

Then one JSON line of per-kernel numbers and, last, the result line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import time

import numpy as np
import torch

import fedml_tpu_torch
from fedml_tpu_torch import FedMLRunner
from fedml_tpu_torch.ml.engine.model_bundle import FlatVariables, ModelBundle
from fedml_tpu_torch.models.cv import CIFARResNet
from fedml_tpu_torch.ops import cuda_build, epilogue
from fedml_tpu_torch.simulation.parrot.parrot_api import ParrotAPI

ROOT = os.path.dirname(os.path.abspath(__file__))
ROUNDS = 3
#: the JAX package's north-star config (bench.py), cut to 3 rounds, with
#: the synthetic stand-in at the 50k/10k size of CIFAR-10
MAIN_CONFIG = dict(
    dataset="cifar10", model="resnet56", training_type="simulation",
    backend="parrot", partition_method="hetero", partition_alpha=0.5,
    client_num_in_total=100, client_num_per_round=10, comm_round=ROUNDS,
    epochs=1, batch_size=32, learning_rate=0.05, frequency_of_the_test=1000,
    enable_tracking=False, compute_dtype="bfloat16", hetero_buckets=10,
    hetero_bucket_cap=0.8, data_scale=10, synthetic_hard=True,
    random_seed=0,
    data_cache_dir=os.path.join(ROOT, ".data_cache", "chip_smoke"))

#: the main path's kernels: (name, source, the TPU kernel it replaces)
KERNELS = [("weighted_reduce", "fedml_tpu_torch/csrc/weighted_reduce.cu",
            "fedml_tpu/ops/epilogue.py:153")]
F32_TOL = (2e-6, 2e-6)          # (atol, rtol): float32 sums in another order
BF16_TOL = (1e-6, 2.0 ** -8)    # one bfloat16 step on a last-bit difference


def phase(n, name, msg):
    print(f"[{n}/7 {name}] {msg}", flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def card_peaks(name):
    """(bytes/s, float32 FLOP/s outside the tensor cores) of the card, from
    NVIDIA's data sheets, at the full power limit."""
    if "H200" in name:
        return 4.8e12, 67e12
    if "H100" in name and "PCIe" in name:
        return 2.0e12, 51e12
    if "H100" in name and "NVL" in name:
        return 3.9e12, 60e12
    if "H100" in name:
        return 3.35e12, 67e12
    raise RuntimeError(f"no peak figures for {name!r}")


# ---------------------------------------------------------------- phases
def device_phase():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs an NVIDIA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    phase(1, "device", f"{name}, {torch.cuda.device_count()} card(s), "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi, flush=True)
    return name, smi


def build_phase():
    t0 = time.perf_counter()
    paths = cuda_build.build_all([k[0] for k in KERNELS])
    secs = time.perf_counter() - t0
    ptxas = [ln.strip() for name in paths
             for ln in cuda_build.build_logs.get(name, "").splitlines()
             if "registers" in ln or "spill" in ln]
    phase(2, "build", f"{len(paths)} kernel source(s) built from "
          f"fedml_tpu_torch/csrc in {secs:.1f} s with "
          f"{cuda_build.nvcc_path()}: "
          + " | ".join(f"{n} -> {os.path.relpath(p, ROOT)}"
                       for n, p in paths.items()))
    for ln in ptxas:
        print(f"    ptxas: {ln}", flush=True)
    return secs


def _cases(d_main):
    """(label, C, D, dtype, weights kind) — the cases of
    tests/test_torch_epilogue.py, a ragged odd D, 1024 clients, and the
    main path's flat buffer."""
    return [("f32", 5, 7 * 130, torch.float32, "pos"),
            ("bf16", 5, 7 * 130, torch.bfloat16, "pos"),
            ("masked", 6, 7 * 130, torch.float32, "masked"),
            ("all_zero", 4, 7 * 130, torch.float32, "zero"),
            ("int32", 5, 9, torch.int32, "pos"),
            ("one_client", 1, 9, torch.float32, "pos"),
            ("ragged", 3, 1027, torch.float32, "pos"),
            ("ragged_bf16", 3, 1031, torch.bfloat16, "pos"),
            ("c1024", 1024, 4099, torch.float32, "pos"),
            ("main_f32", 10, d_main, torch.float32, "pos"),
            ("main_bf16", 10, d_main, torch.bfloat16, "pos")]


def _inputs(c, d, dtype, kind, gen, dev):
    if dtype == torch.int32:
        x = torch.randint(0, 50, (c, d), generator=gen, dtype=torch.int32)
    else:
        x = torch.randn(c, d, generator=gen).to(dtype)
    w = torch.rand(c, generator=gen) * 2.5 + 0.5
    if kind == "masked":
        w[[1, 4]] = 0.0
    elif kind == "zero":
        w.zero_()
    return x.to(dev), w.to(dev)


def main_flat_size():
    """Columns of the main path's [C, D] float32 buffer: ResNet-56's
    variables, laid out as the Parrot engine lays them out."""
    flat = FlatVariables(CIFARResNet(depth=56, num_classes=10))
    check(list(flat.flat) == [torch.float32], "ResNet-56 is all float32")
    return flat.flat[torch.float32].numel()


def kernel_phase(dev):
    d_main = main_flat_size()
    gen = torch.Generator().manual_seed(0)
    errs = {}
    for label, c, d, dtype, kind in _cases(d_main):
        x, w = _inputs(c, d, dtype, kind, gen, dev)
        got = epilogue.weighted_reduce(x, w)
        torch.cuda.synchronize()
        ref = epilogue.weighted_reduce_reference(x, w)
        torch.cuda.synchronize()
        check(got.dtype == ref.dtype and got.shape == ref.shape,
              f"{label}: kernel gave {got.dtype} {tuple(got.shape)}, plain "
              f"version {ref.dtype} {tuple(ref.shape)}")
        atol, rtol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
        diff = (got.float() - ref.float()).abs()
        bound = atol + rtol * ref.float().abs()
        err = float(diff.max())
        check(bool(torch.isfinite(got.float()).all()),
              f"{label}: non-finite kernel output")
        check(bool((diff <= bound).all()),
              f"{label}: kernel vs plain max |err| {err:.3g} exceeds "
              f"atol {atol:g} + rtol {rtol:g}·|ref|")
        errs[label] = err
    phase(3, "kernels", "weighted_reduce vs plain version: " + ", ".join(
        f"{k} {v:.2e}" for k, v in errs.items())
        + f" (tolerance atol+rtol·|ref|: f32 {F32_TOL}, bf16 {BF16_TOL}); "
        f"main shape [10, {d_main}]")
    return d_main, errs["main_f32"]


def _time_ms(fn, flush, n=50, warmup=5):
    """Median device time of ``fn`` over ``n`` calls, each on a cold L2:
    a 256 MB write precedes every call (the round's reduce reads client
    rows written long before), and keeps the card busy while the host
    enqueues the call, so host overhead does not enter the interval."""
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    for s, e in zip(starts, ends):
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def timing_phase(dev, d_main, card):
    c = 10
    gen = torch.Generator().manual_seed(1)
    x, w = _inputs(c, d_main, torch.float32, "pos", gen, dev)
    wn = w / torch.clamp(w.sum(), min=1e-12)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    plain_ms = _time_ms(lambda: epilogue.weighted_reduce_reference(x, w),
                        flush)
    kernel_ms = _time_ms(lambda: epilogue.weighted_reduce(x, w), flush)
    library_ms = _time_ms(lambda: torch.matmul(wn, x), flush)
    kernel_ms_2 = _time_ms(lambda: epilogue.weighted_reduce(x, w), flush)
    plain_ms_2 = _time_ms(lambda: epilogue.weighted_reduce_reference(x, w),
                          flush)
    bw, flops = card_peaks(card)
    nbytes = c * d_main * 4 + d_main * 4 + c * 4
    ops = 2 * c * d_main
    t_bytes, t_ops = nbytes / bw * 1e3, ops / flops * 1e3
    bound_ms = max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    phase(4, "timing", f"weighted_reduce at [10, {d_main}] f32, cold L2, "
          f"median of 50: kernel {kernel_ms:.4f} / {kernel_ms_2:.4f} ms, "
          f"plain {plain_ms:.4f} / {plain_ms_2:.4f} ms, library "
          f"matmul(wn, x) {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by}: {nbytes / 1e6:.2f} MB at {bw / 1e12:.2f} TB/s) "
          f"-> {bound_ms / kernel_ms:.1%} of the bound")
    return dict(ms=statistics.median([kernel_ms, kernel_ms_2]),
                plain_ms=statistics.median([plain_ms, plain_ms_2]),
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)


def _small_round(device):
    """One uniform Parrot round of a ResNet-8 in float32 on ``device``,
    from the same seeded variables: the global model as a flax tree."""
    args = fedml_tpu_torch.Config(
        dataset="cifar10", backend="parrot", client_num_in_total=4,
        client_num_per_round=2, comm_round=1, batch_size=16,
        learning_rate=0.05, data_scale=0.02, compute_dtype="float32",
        frequency_of_the_test=1,
        data_cache_dir=os.path.join(ROOT, ".data_cache", "chip_smoke_small"))
    dataset = fedml_tpu_torch.data.load(args)
    module = CIFARResNet(depth=8, num_classes=10,
                         generator=torch.Generator().manual_seed(0))
    api = ParrotAPI(args, device, dataset,
                    ModelBundle(module, (32, 32, 3), 10))
    final = api.train()
    return api.global_flax_variables(), final


def parity_phase(dev):
    gpu_vars, gpu_m = _small_round(dev)
    cpu_vars, cpu_m = _small_round(torch.device("cpu"))
    worst = 0.0

    def walk(a, b):
        nonlocal worst
        if isinstance(a, dict):
            check(a.keys() == b.keys(), "variable trees differ")
            for k in a:
                walk(a[k], b[k])
        else:
            worst = max(worst, float(np.abs(a - b).max()))

    walk(gpu_vars, cpu_vars)
    # cuDNN sums convolutions in another order than the CPU; one SGD epoch
    # at lr 0.05 keeps that at float32 rounding times the gradient's scale
    check(worst <= 1e-3, f"card vs CPU round: max |Δvariables| {worst:.3g}")
    dl = abs(gpu_m["train_loss"] - cpu_m["train_loss"])
    check(dl <= 1e-4 * max(1.0, abs(cpu_m["train_loss"])),
          f"card vs CPU round: train_loss {gpu_m['train_loss']} vs "
          f"{cpu_m['train_loss']}")
    phase(5, "parity", f"ResNet-8 f32 round, card vs CPU: max |Δvariables| "
          f"{worst:.2e} (tol 1e-3), train_loss {gpu_m['train_loss']:.6f} vs "
          f"{cpu_m['train_loss']:.6f}, test_acc {gpu_m['test_acc']:.4f} vs "
          f"{cpu_m['test_acc']:.4f}")


def main_path_phase():
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in epilogue.LAUNCHES:
        epilogue.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    args = fedml_tpu_torch.init(fedml_tpu_torch.Config(**MAIN_CONFIG))
    device = fedml_tpu_torch.device.get_device(args)
    dataset = fedml_tpu_torch.data.load(args)
    t_data = time.perf_counter() - t0
    bundle = fedml_tpu_torch.model.create(args, dataset[-1])
    runner = FedMLRunner(args, device, dataset, bundle)
    api = runner.runner
    start = {dt: f.clone() for dt, f in api.global_vars.items()}
    final = runner.run()
    torch.cuda.synchronize()
    launches = dict(epilogue.LAUNCHES)
    total = time.perf_counter() - t0

    hist = api.round_history
    check(len(hist) == ROUNDS, f"{len(hist)} rounds ran, not {ROUNDS}")
    for r in hist:
        print(f"    round {r['round']}: train_loss {r['train_loss']:.6f}, "
              f"{r['train_seconds']:.3f} s, {r['samples_trained']:.0f} "
              f"samples trained", flush=True)
        check(math.isfinite(r["train_loss"]),
              f"round {r['round']}: train_loss {r['train_loss']}")
    secs = sum(r["train_seconds"] for r in hist)
    steady = hist[1:]
    steady_secs = sum(r["train_seconds"] for r in steady)
    samples = sum(r["samples_trained"] for r in hist)
    moved = max(float((api.global_vars[dt] - start[dt]).abs().max())
                for dt in start)
    check(moved > 0.0, "the global variables did not move")
    check(all(bool(torch.isfinite(f).all())
              for f in api.global_vars.values()),
          "non-finite global variables")
    check(math.isfinite(final["test_acc"]) and 0 <= final["test_acc"] <= 1,
          f"test_acc {final['test_acc']}")
    groups = len(api.global_vars)
    check(launches["weighted_reduce"] == ROUNDS * groups,
          f"weighted_reduce launched {launches['weighted_reduce']} times in "
          f"{ROUNDS} rounds over {groups} dtype group(s)")
    peak = torch.cuda.max_memory_allocated()
    phase(6, "main path", f"Parrot FedAvg {args.model} {args.compute_dtype}, "
          f"{api.n_total} "
          f"clients, {api.n_buckets} strata, {ROUNDS} rounds: "
          f"{ROUNDS / secs:.3f} rounds/s over all rounds "
          f"({len(steady) / steady_secs:.3f} after round 0), "
          f"{samples / secs:.1f} samples/s, final test_acc "
          f"{final['test_acc']:.4f} test_loss {final['test_loss']:.4f}, "
          f"peak memory {peak / 2**30:.2f} GiB, launches {launches}, "
          f"data {t_data:.1f} s, whole phase {total:.1f} s")
    return launches, api


def trace_phase(api):
    """One client of the middle size stratum, trained and aggregated by the
    main path's round code, timed once plainly and once under
    ``torch.profiler`` (same seed, same work): the device's busy time from
    the profiler's kernel records against the plain wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def one_client_round():
        rm = api._bucketed_round_step(torch.Generator().manual_seed(99))
        float(rm["train_loss"])
        torch.cuda.synchronize()

    buckets = api.buckets
    api.buckets = [buckets[len(buckets) // 2]]
    try:
        one_client_round()                      # warm
        t0 = time.perf_counter()
        one_client_round()
        wall = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            one_client_round()
    finally:
        api.buckets = buckets
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        phase(7, "trace", "the profiler recorded no device activity: device "
              "busy time not measured")
        return
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e6
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0) + e.time_range.elapsed_us()
    nb = api.buckets[len(api.buckets) // 2]["nb"]
    phase(7, "trace", f"one client ({nb} batches of 32) of the middle "
          f"stratum, trained and aggregated: wall {wall:.3f} s, device busy "
          f"{busy:.3f} s ({busy / wall:.1%}; idle {1 - busy / wall:.1%}), "
          f"{len(kernels)} device activities "
          f"({len(kernels) / nb:.0f} per batch)")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        print(f"    {us / 1e3:9.2f} ms  {name[:100]}", flush=True)


def main():
    name, _ = device_phase()
    # the port's device choice: the card, with TF32 off
    dev = fedml_tpu_torch.device.get_device(
        fedml_tpu_torch.Config(device_type="cuda"))
    build_phase()
    d_main, err = kernel_phase(dev)
    timing = timing_phase(dev, d_main, name)
    parity_phase(dev)
    launches, api = main_path_phase()
    trace_phase(api)
    kname, source, replaces = KERNELS[0]
    print(json.dumps({"kernels": [dict(
        name=kname, route="cuda", source=source, replaces=replaces,
        launches=launches[kname], max_abs_err=err, **timing)]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
