#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``fedml_tpu_torch``) on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It needs one CUDA card, ``nvcc`` and ``nvidia-smi``; without a card it
exits non-zero and prints no result.  Phases, one line each; any failure
raises and ends the run with a non-zero exit:

1. device — the card's name and power limit as ``nvidia-smi`` reports them;
2. build — every CUDA kernel source of the paths, compiled from
   ``fedml_tpu_torch/csrc`` (one ``nvcc`` per source, started together),
   with ptxas' registers and spills;
3. kernels — each kernel against its plain PyTorch version on the card, on
   the unit-test cases and at the main paths' shapes, with the tolerance:
   the weighted reduce (also on a column range), the four channels of the
   fused epilogue (also with the step's row read from the device table,
   adam's t by value and from a device tensor at t = 1, 2, 3 and 300), the
   async ``fold_buffer`` (its ``none`` channel), the
   flash-attention forward (o, l and m; causal and not, T of 32, 80, 200
   and 512, head dims 16, 32, 64 and 128, float32 and bfloat16, keys of
   another length than the queries, scores of large magnitude, no key or
   one, and a causal length of 97), the int8 wire codec's quantize
   and dequantize, bit for bit (the unit-test sizes, with rows that hold a
   NaN or an infinity, ResNet-56's whole flat vector as one segment, its
   287 leaves as segments, which the dequantize takes by value, and 2,100
   leaves of 1 to 3 values, past that form's capacity, through the device
   table), top-k selection on ties against
   the CPU's, bit for bit, and the fed-LLM adapter fold, bit for bit
   (float32 and bfloat16 adapters, ``server_lr`` 0, 1 and 0.37, BERT-tiny's
   10-leaf rank-4 table, rank-3 leaves that are no multiples of 4, and a
   misaligned buffer, in both its launch forms: one flat range and a
   device table), and the multi-client conv's
   forward and weight-gradient kernels (the forward, dx through the
   forward kernel and dw, at ``tests/test_mc_conv.py``'s five cases and
   ResNet-56's eight conv shapes at 10 clients of batch 32, float32 and
   bfloat16), and
   ``ops/pallas_ops``' weighted average and int8 product (within the
   float32 bound of a sum of C or K terms; the tests' cases, ragged and
   misaligned operands, M on both sides of the CUDA-core path's limit,
   and the main paths' shapes) and quantize-mask
   (bit for bit, with out-of-range, infinite and NaN values);
4. timing — at the paths' shapes, each kernel, its plain version and, where
   one exists, one PyTorch library call, beside the least time the card
   could take (the flash forward at both language-model paths' eval
   shapes, bfloat16 and float32, and at 512 tokens; adam's fused epilogue
   also in the fused rounds' launch, its step count on the device);
5. parity — one round of the port on the card against the same round on
   the CPU (the CPU path is held to the JAX package by the tests): FedAvg,
   FedOpt with server adam, sgd with momentum 0.9 and sgd without, and
   FedProx, FedNova, SCAFFOLD, FedDyn and Mime (their server state too), on
   a ResNet-8; FedOpt (server adam) on the transformer language model
   at dropout 0, whose training runs the flash kernel forward and the
   blockwise backward; one cross-silo FedAvg round of a ResNet-8 over
   INPROC, 3 silos, with the int8 wire codec; and one fed-LLM round over
   INPROC (2 silos, the transformer at dropout 0 in float32, rank 4);
6. main path, FedAvg — the north-star config of ``bench.py`` (Parrot
   FedAvg, ResNet-56 at full width in bfloat16, 100 clients split
   Dirichlet(0.5), 10 per round in 10 size strata capped at 0.8, batch 32,
   lr 0.05) for 3 rounds on the 50k/10k hard synthetic CIFAR-10 stand-in,
   through ``init → device → data → model → FedMLRunner(...).run()``;
7. main path, FedOpt — the same config with ``federated_optimizer:
   FedOpt`` (server adam at ``server_lr`` 1e-3, the JAX defaults);
8. trace — one client of the FedOpt path's round under ``torch.profiler``:
   the device's busy share of its wall time, the kernels launched per
   batch and the ones that take the device time;
9. main path, FedOpt on BERT-tiny — the BASELINE config 3 (Parrot FedOpt,
   server adam at ``server_lr`` 0.1, lr 0.05, ``TinyTransformerLM`` at
   full width in bfloat16 with dropout 0.1, ``fed_shakespeare``, 100
   clients split Dirichlet(0.5) by first token, 10 per round, batch 32) for
   3 rounds on 20,000 train and 4,000 test sequences of 80 tokens, with a
   token-accuracy eval every round: the eval passes run the flash kernel;
10. trace — one client of that path's round, as phase 8;
11. main path, cross-silo — synchronous FedAvg over INPROC (the server and
    8 silo threads in one process), ResNet-56 at full width in bfloat16,
    8 silos split Dirichlet(0.5), all 8 every round, batch 32, lr 0.05, 3
    rounds with an eval every round, on the 5k/1k hard synthetic CIFAR-10
    stand-in, through the same five steps: with ``wire_compression:
    int8`` (every broadcast and upload through the wire kernels) and raw,
    in turns (int8, raw, raw, int8), with the wire bytes of each and the
    launch counts the protocol implies;
12. main path, fed-LLM — cross-silo LoRA SFT over INPROC where only
    adapter trees cross the wire, the JAX package's
    ``benchmarks/llm_bench.py --federated --quick`` config: shakespeare,
    ``transformer`` at full width (vocab 90, dim 128, 2 layers, 2 heads,
    dropout 0.1) in float32, 2 silos all in every round, LoRA rank 4,
    sequences of 32, batch 4, lr 3e-3, ``data_scale`` 0.5, 3 rounds with an
    eval every round, raw and with ``wire_compression: int8``, in turns:
    rounds/s, train tokens/s per silo, eval seconds, wire bytes and the
    uplink's reduction against the full model's bytes, and the launches
    the protocol implies (the fold, as one flat range, and the weighted
    reduce once a round, the flash kernel once per layer of every eval
    batch);
13. trace — one silo's local epoch of that path under ``torch.profiler``,
    as phases 8 and 10;
14. main path, multi-client conv — ResNet-56's 57 convolutions in network
    order (with its ReLUs and residual adds, no BatchNorm) at 10 clients
    with per-client weights, batch 32, bfloat16, forward and backward
    through ``ops/pallas_mc_conv.conv_for_clients``: the launches the
    shapes imply (109 forward kernels, 57 weight gradients, 4 library
    input gradients), the pass in float32 and bfloat16 held to the same
    pass in float64 (no farther from it than the library arm's, one
    grouped ``F.conv2d`` a conv), and its device time against that arm
    and its summed bound;
15. main path, ``ops/pallas_ops`` — each of its three kernels driven at a
    width the repo runs, through its public entries: the weighted average
    (``agg_stacked_pallas``) over a stacked 10-client ResNet-56 variable
    tree (860,026 values, integer sample counts as weights), held to its
    plain version and to the port's ``agg_stacked`` (kernel 1); SecAgg's
    bulk round over ResNet-56's 860,026 parameters for 8 silos, each
    masking its update with ``quantize_mask`` and its own
    ``prg_mask_like`` mask, the server summing the words modulo 2^32,
    unmasking and dequantizing (bit for bit against the two-step
    ``mask_model(quantize(x))``, the sum within 8·2^-17 of the float
    sum); and one decode step's 72 ``int8_matmul`` products over a
    GPT-2-small-width parameter dict quantized by ``quantize_lm_params``
    (``benchmarks/serve_bench.py``'s widths: dim 768, 12 layers, decode
    batch 64), at M = 64 and M = 1, with the device kernels of each step
    counted in a ``torch.profiler`` trace (one a product);
16. main path, fused rounds — the north-star config of phase 6 with
    ``fused_rounds: true`` through the same five steps, FedAvg and then
    FedOpt (server adam at 1e-3), 8 rounds in two chunks of 4 with an eval
    after each: round 1 runs uncaptured, the round is captured once into a
    CUDA graph and replayed for the other 7.  It prints the capture and
    instantiate seconds, the graph's nodes by kind and its epilogue
    kernels by name (one weighted reduce per dtype group on FedAvg; one
    fused epilogue and one weighted reduce on FedOpt), rounds/s over the
    replayed chunk beside phases 6-7's, peak memory, the device's busy
    share over one replayed chunk, and the card; it checks that a replayed
    chunk raises nothing under ``torch.cuda.set_sync_debug_mode("error")``
    and, under deterministic algorithms, that 2 replayed FedOpt rounds of
    ResNet-56 equal 2 uncaptured runs of the same round body, bit for bit;
17. main path, BASELINE config 3 fused — phase 9's config with
    ``fused_rounds: true`` and a ``checkpoint_dir``, 8 rounds in two chunks
    of 4 with an eval (and a checkpoint) after each: dropout 0.1 drawn
    from the round's second card generator, server adam on the fused
    channel, the flash kernel in the evals.  It prints the capture and
    instantiate seconds, the graph's nodes by kind and its fused-epilogue
    node (1), rounds/s over the replayed chunk beside phase 9's, the flash
    launches of the two evals and peak memory.  Then a fresh ``ParrotAPI``
    restores the chunk-boundary checkpoint (round 4's start), checked bit
    for bit against the file before its first round, captures and replays
    one chunk with the seed of the first drive's second chunk; and the
    unfused yogi arm (optax's yogi, its step count on the device) runs 3
    fused rounds of ResNet-20 on the north-star data;
18. main path, the other federated optimizers — (a) the north-star config
    of phase 6 per round as FedProx (μ 0.1), FedNova, SCAFFOLD, FedDyn (α
    0.01) and Mime (server momentum 0.9), 2 rounds and the evals each:
    rounds/s, the eval metrics, the weighted-reduce launches against those
    the arm implies (per round and dtype group: 1 for FedProx and FedDyn,
    2 for FedNova, SCAFFOLD and Mime), peak memory; (b) SCAFFOLD fused at
    the same width (one uncaptured round, the capture, 3 replays; a
    replayed round under sync-debug "error" that changes only its sampled
    clients' rows of ``c_locals``), and the other four arms fused on
    ResNet-20, 2 clients a round (1 uncaptured round, the capture, 2
    replays): capture and instantiate seconds, the graph's weighted-reduce
    nodes, rounds/s over the replays; (c) the SP backend: BASELINE config
    1 (FedAvg logistic regression on the 60k/10k MNIST stand-in, 10
    clients all in every round, 4 rounds) and config 3's FedProx arm at
    phase 9's width (2 rounds, an eval each, the flash kernel in every
    eval).

Every path (the fold in phase 3, the card rounds of phase 5, phases 6, 7,
9, 11, 12, 14, 15, 16, 17 and 18) is driven with the kernels' launch counts
set to 0 just before it and read just after (phases 16 and 17: the
uncaptured round and the capture; replays launch nothing from Python, and
the graph's nodes are counted instead).  Then one JSON line of per-kernel numbers and, last, the
result line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import ctypes
import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import time

import numpy as np
import torch
import torch.nn.functional as F


import fedml_tpu_torch
from fedml_tpu_torch import FedMLRunner
from fedml_tpu_torch.core.mpc import secagg
from fedml_tpu_torch.ml.aggregator.agg_operator import agg_stacked, fold_buffer
from fedml_tpu_torch.ml.engine.model_bundle import (
    TASK_LM,
    FlatVariables,
    ModelBundle,
)
from fedml_tpu_torch.models.cv import CIFARResNet
from fedml_tpu_torch.models.nlp import TinyTransformerLM
from fedml_tpu_torch.ops import cuda_build, epilogue
from fedml_tpu_torch.ops.cuda_graphs import graph_nodes
from fedml_tpu_torch.ops import pallas_attention as attn
from fedml_tpu_torch.ops import pallas_mc_conv as mcc
from fedml_tpu_torch.ops import pallas_ops as po
from fedml_tpu_torch.ops import wire_compression as wc
from fedml_tpu_torch.serving.quantization import (
    _MATMUL_KEYS,
    dequantize_matrix,
    quantize_lm_params,
    quantize_matrix_int8,
)
from fedml_tpu_torch.simulation.parrot.parrot_api import (
    SAMPLE_SEED_OFFSET,
    ParrotAPI,
)
from fedml_tpu_torch.train.fed_llm import FedLLMAggregator, FedLLMTrainer
from fedml_tpu_torch.train.fed_llm.trainer import (
    FED_LLM_TOKENS,
    FED_LLM_TRAIN_SECONDS,
)
from fedml_tpu_torch.utils.checkpoint import RoundCheckpointer
from fedml_tpu_torch.utils.compression import WIRE_BYTES, WireCodec, decode_delta
from fedml_tpu_torch.utils.serialization import estimate_nbytes
from fedml_tpu_torch.utils.tree import tree_leaves, tree_map
from fedml_tpu_torch.utils.weights import tree_from_module

# cuBLAS's deterministic workspace, for phase 16's bit-for-bit check under
# torch.use_deterministic_algorithms (read when cuBLAS is first used)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

ROOT = os.path.dirname(os.path.abspath(__file__))
ROUNDS = 3
PHASES = 18
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
#: FedOpt with the JAX package's server defaults (arguments.py: adam, 1e-3)
FEDOPT = dict(federated_optimizer="FedOpt", server_optimizer="adam",
              server_lr=1e-3)
#: BASELINE config 3 (tests/test_baseline_configs.py:40-50) at the size of
#: a real run: 100 clients, 20,000 train and 4,000 test sequences of 80
LM_CONFIG = dict(
    dataset="fed_shakespeare", model="bert_tiny", training_type="simulation",
    backend="parrot", partition_method="hetero", partition_alpha=0.5,
    client_num_in_total=100, client_num_per_round=10, comm_round=ROUNDS,
    epochs=1, batch_size=32, learning_rate=0.05, frequency_of_the_test=1,
    enable_tracking=False, compute_dtype="bfloat16", data_scale=10,
    random_seed=0, federated_optimizer="FedOpt", server_optimizer="adam",
    server_lr=0.1,
    data_cache_dir=os.path.join(ROOT, ".data_cache", "chip_smoke_lm"))
#: the cross-silo path: FedAvg over INPROC, 8 silos all in every round,
#: on the 5,000 / 1,000 hard synthetic CIFAR-10 stand-in
SILOS = 8
CS_CONFIG = dict(
    dataset="cifar10", model="resnet56", training_type="cross_silo",
    backend="INPROC", role="simulated", partition_method="hetero",
    partition_alpha=0.5, client_num_in_total=SILOS,
    client_num_per_round=SILOS, comm_round=ROUNDS, epochs=1, batch_size=32,
    learning_rate=0.05, frequency_of_the_test=1, enable_tracking=False,
    compute_dtype="bfloat16", data_scale=1, synthetic_hard=True,
    random_seed=0,
    data_cache_dir=os.path.join(ROOT, ".data_cache", "chip_smoke_cs"))

#: the fed-LLM path: the JAX package's ``llm_bench.py --federated --quick``
#: config (shakespeare, the full-width transformer in float32, 2 silos,
#: LoRA rank 4, sequences of 32, batch 4, lr 3e-3, data_scale 0.5), 3 rounds
LLM_SILOS = 2
FED_LLM_CONFIG = dict(
    dataset="shakespeare", model="transformer", training_type="cross_silo",
    backend="INPROC", role="simulated", client_num_in_total=LLM_SILOS,
    client_num_per_round=LLM_SILOS, comm_round=ROUNDS, epochs=1,
    batch_size=4, learning_rate=3e-3, data_scale=0.5,
    frequency_of_the_test=1, random_seed=0, enable_tracking=False,
    compute_dtype="float32", fed_llm=True, lora_rank=4, fed_llm_seq_len=32,
    data_cache_dir=os.path.join(ROOT, ".data_cache", "chip_smoke_llm"))

EPI = "fedml_tpu_torch/csrc/fused_epilogue.cu"
#: the paths' kernels: (name, source, the TPU kernel it replaces, channel)
KERNELS = [
    ("weighted_reduce", "fedml_tpu_torch/csrc/weighted_reduce.cu",
     "fedml_tpu/ops/epilogue.py:153", None),
    ("fused_epilogue.mix", EPI, "fedml_tpu/ops/epilogue.py:159", "none"),
    ("fused_epilogue.sgd", EPI, "fedml_tpu/ops/epilogue.py:165", "sgd"),
    ("fused_epilogue.momentum", EPI, "fedml_tpu/ops/epilogue.py:173",
     "momentum"),
    ("fused_epilogue.adam", EPI, "fedml_tpu/ops/epilogue.py:183", "adam"),
    ("flash_attention", "fedml_tpu_torch/csrc/flash_attention.cu",
     "fedml_tpu/ops/pallas_attention.py:111", None),
    ("wire_compression.quantize", "fedml_tpu_torch/csrc/wire_compression.cu",
     "fedml_tpu/ops/wire_compression.py:62", None),
    ("wire_compression.dequantize",
     "fedml_tpu_torch/csrc/wire_compression.cu",
     "fedml_tpu/ops/wire_compression.py:108", None),
    ("fold_delta", "fedml_tpu_torch/csrc/fold_delta.cu",
     "fedml_tpu/ops/epilogue.py:199", None),
    ("mc_conv.fwd", "fedml_tpu_torch/csrc/mc_conv.cu",
     "fedml_tpu/ops/pallas_mc_conv.py:71", None),
    ("mc_conv.wgrad", "fedml_tpu_torch/csrc/mc_conv.cu",
     "fedml_tpu/ops/pallas_mc_conv.py:85", None),
    ("pallas_ops.weighted_average", "fedml_tpu_torch/csrc/pallas_ops.cu",
     "fedml_tpu/ops/pallas_ops.py:48", None),
    ("pallas_ops.quantize_mask", "fedml_tpu_torch/csrc/pallas_ops.cu",
     "fedml_tpu/ops/pallas_ops.py:104", None),
    ("pallas_ops.int8_matmul", "fedml_tpu_torch/csrc/pallas_ops.cu",
     "fedml_tpu/ops/pallas_ops.py:141", None),
]
CHANNELS = ("none", "sgd", "momentum", "adam")
# (atol, rtol): float32 sums in another order — the fused channels round
# every other operation as their plain version does (built without fma
# contraction), so a float32 ulp of the reduce is all that differs
F32_TOL = (2e-6, 2e-6)
BF16_TOL = (1e-6, 2.0 ** -8)    # one bfloat16 step on a last-bit difference


#: host clock of each phase's last line so far, for the wall summary
_PHASE_LAST = {}
_T0 = time.perf_counter()


def phase(n, name, msg):
    print(f"[{n}/{PHASES} {name}] {msg}", flush=True)
    _PHASE_LAST[n] = time.perf_counter()


def phase_walls():
    """The script's wall, and each phase's seconds: from the previous
    phase's last line to its own (every phase prints as its work ends)."""
    parts, prev = [], _T0
    for n in sorted(_PHASE_LAST):
        parts.append(f"{n}: {_PHASE_LAST[n] - prev:.1f}")
        prev = _PHASE_LAST[n]
    return (f"chip_smoke wall {time.perf_counter() - _T0:.1f} s; seconds "
            f"by phase " + ", ".join(parts))


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


# torch.profiler keeps a device record only where the record's timestamp
# falls inside the trace's window on the host's clock, and on the H100
# machines the two clocks stand apart by an amount that varies from trace
# to trace, so that a kernel's record can carry a time before the host
# launched it: records near an edge of the window are lost (a few of a
# decode step's kernels in some traces, all of them in one run of this
# script).  Each traced call therefore sits this much host sleep inside
# its window, and the warm-up call as far outside it.
TRACE_PAD_S = 0.2


def reset_launches():
    for counts in (epilogue.LAUNCHES, epilogue.FOLD_FORMS, attn.LAUNCHES,
                   wc.LAUNCHES, wc.QUANT_FORMS, wc.DEQUANT_FORMS,
                   mcc.LAUNCHES, po.LAUNCHES, po.WAVG_FORMS):
        for k in counts:
            counts[k] = 0


def read_launches():
    """The launch counts, with ``fused_epilogue`` the sum of its channels,
    the wire kernels as ``wire_compression.<kernel>``, and the launches by
    form of the fold as ``fold_delta.<form>``, of the wire kernels as
    ``quantize_form.<form>`` and ``dequantize_form.<form>``, and of the
    weighted average as ``weighted_average_form.<form>``."""
    counts = dict(epilogue.LAUNCHES, **attn.LAUNCHES, **mcc.LAUNCHES,
                  **po.LAUNCHES,
                  **{f"wire_compression.{k}": n
                     for k, n in wc.LAUNCHES.items()},
                  **{f"fold_delta.{k}": n
                     for k, n in epilogue.FOLD_FORMS.items()},
                  **{f"quantize_form.{k}": n
                     for k, n in wc.QUANT_FORMS.items()},
                  **{f"dequantize_form.{k}": n
                     for k, n in wc.DEQUANT_FORMS.items()},
                  **{f"weighted_average_form.{k}": n
                     for k, n in po.WAVG_FORMS.items()})
    counts["fused_epilogue"] = sum(
        n for k, n in counts.items() if k.startswith("fused_epilogue."))
    return counts


def card_peaks(name):
    """(bytes/s, float32 FLOP/s outside the tensor cores, dense bfloat16
    tensor-core FLOP/s) of the card, from NVIDIA's data sheets, at the full
    power limit."""
    if "H200" in name:
        return 4.8e12, 67e12, 989e12
    if "H100" in name and "PCIe" in name:
        return 2.0e12, 51e12, 756e12
    if "H100" in name and "NVL" in name:
        return 3.9e12, 60e12, 835e12
    if "H100" in name:
        return 3.35e12, 67e12, 989e12
    raise RuntimeError(f"no peak figures for {name!r}")


# ---------------------------------------------------------------- phases
def _smi_line():
    """The card's name and power limit as ``nvidia-smi`` prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def device_phase():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs an NVIDIA card")
    smi = _smi_line()
    name = torch.cuda.get_device_name(0)
    phase(1, "device", f"{name}, {torch.cuda.device_count()} card(s), "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi, flush=True)
    return name, smi


def build_phase():
    t0 = time.perf_counter()
    names = ["weighted_reduce", "fused_epilogue", "flash_attention",
             "wire_compression", "fold_delta", "mc_conv", "pallas_ops"]
    paths = cuda_build.build_all(names)
    secs = time.perf_counter() - t0
    phase(2, "build", f"{len(paths)} kernel sources built from "
          f"fedml_tpu_torch/csrc in {secs:.1f} s with "
          f"{cuda_build.nvcc_path()} {' '.join(cuda_build.NVCC_FLAGS)}: "
          + " | ".join(f"{n} -> {os.path.relpath(p, ROOT)}"
                       for n, p in paths.items()))
    for name in names:
        log = cuda_build.build_logs.get(name, "")
        regs = re.findall(r"Used (\d+) registers", log)
        spills = [ln.strip() for ln in log.splitlines()
                  if "spill" in ln and "0 bytes spill stores, 0 bytes spill "
                  "loads" not in ln]
        print(f"    ptxas {name}: {len(regs)} kernels, registers "
              f"{sorted(set(regs), key=int)}; spills: "
              f"{spills[:4] or 'none'}",
              flush=True)
    return secs


def _err(got, ref, tol, label):
    """Max |got − ref|, checked against atol + rtol·|ref|."""
    atol, rtol = tol
    check(got.dtype == ref.dtype and got.shape == ref.shape,
          f"{label}: kernel gave {got.dtype} {tuple(got.shape)}, plain "
          f"version {ref.dtype} {tuple(ref.shape)}")
    g, r = got.float(), ref.float()
    check(bool(torch.isfinite(g).all()), f"{label}: non-finite kernel output")
    diff = (g - r).abs()
    err = float(diff.max())
    check(bool((diff <= atol + rtol * r.abs()).all()),
          f"{label}: kernel vs plain max |err| {err:.3g} exceeds atol "
          f"{atol:g} + rtol {rtol:g}·|ref|")
    return err


def _reduce_cases(d_main):
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


def _weights(c, kind, gen):
    w = torch.rand(c, generator=gen) * 2.5 + 0.5
    if kind == "masked":
        w[[1, 4]] = 0.0
    elif kind == "zero":
        w.zero_()
    return w


def _inputs(c, d, dtype, kind, gen, dev):
    if dtype == torch.int32:
        x = torch.randint(0, 50, (c, d), generator=gen, dtype=torch.int32)
    else:
        x = torch.randn(c, d, generator=gen).to(dtype)
    return x.to(dev), _weights(c, kind, gen).to(dev)


def main_layout():
    """(P, D) of the main path's [C, D] float32 buffer: ResNet-56's
    parameter columns and all its columns, as the Parrot engine lays them
    out."""
    flat = FlatVariables(CIFARResNet(depth=56, num_classes=10))
    check(list(flat.flat) == [torch.float32], "ResNet-56 is all float32")
    return (flat.param_cols[torch.float32],
            flat.flat[torch.float32].numel())


def _fused_cases(p_main, d_main):
    """(label, opt, C, P, row stride, stacked dtype, global dtype, weights,
    s, t) — every channel on float32 and bfloat16 stacked buffers, a
    bfloat16 global, masked and all-zero weights, one client and 1,024, a
    ragged P (the one-column path), adam at t = 1 (zero state) and t = 5
    (random state), s ≠ 1 for mix and sgd, and each channel on the FedOpt
    round's parameter columns."""
    f32, bf16 = torch.float32, torch.bfloat16
    cases = []
    for o in CHANNELS:
        cases += [(f"{o}_f32", o, 5, 910, 910, f32, f32, "pos", 0.7, 5),
                  (f"{o}_bf16", o, 5, 910, 910, bf16, f32, "pos", 0.7, 5)]
    cases += [
        ("adam_bf16_global", "adam", 5, 910, 910, bf16, bf16, "pos", 1.0, 5),
        ("sgd_masked", "sgd", 6, 910, 910, f32, f32, "masked", 1.0, 0),
        ("momentum_all_zero", "momentum", 4, 910, 910, f32, f32, "zero",
         1.0, 0),
        ("adam_one_client", "adam", 1, 9, 9, f32, f32, "pos", 1.0, 5),
        ("mix_c1024", "none", 1024, 4099, 4099, f32, f32, "pos", 0.5, 0),
        ("adam_ragged", "adam", 3, 1027, 1027, f32, f32, "pos", 1.0, 5),
        ("adam_t1", "adam", 5, 910, 910, f32, f32, "pos", 1.0, 0)]
    for o in CHANNELS:
        cases.append((f"round_{o}", o, 10, p_main, d_main, f32, f32, "pos",
                      1.0, 5 if o == "adam" else 0))
    return cases


def _fused_inputs(case, gen, dev, lr=0.1):
    _, opt, c, p, ld, xdt, gdt, kind, s, t = case
    x = torch.randn(c, ld, generator=gen).to(xdt).to(dev)[:, :p]
    g = torch.randn(p, generator=gen).to(gdt).to(dev)
    w = _weights(c, kind, gen).to(dev)
    st = None
    if opt == "momentum":
        st = {"m": torch.randn(p, generator=gen).to(dev)}
    elif opt == "adam":
        st = {"m": (torch.randn(p, generator=gen) if t else
                    torch.zeros(p)).to(dev),
              "v": (torch.rand(p, generator=gen) if t else
                    torch.zeros(p)).to(dev), "t": t}
    return x, g, w, s, epilogue.EpilogueSpec(opt=opt, lr=lr), st


def _clone(st):
    return None if st is None else {
        k: v.clone() if isinstance(v, torch.Tensor) else v
        for k, v in st.items()}


def kernel_phase(dev):
    p_main, d_main = main_layout()
    gen = torch.Generator().manual_seed(0)
    errs = {}
    for label, c, d, dtype, kind in _reduce_cases(d_main):
        x, w = _inputs(c, d, dtype, kind, gen, dev)
        got = epilogue.weighted_reduce(x, w)
        torch.cuda.synchronize()
        ref = epilogue.weighted_reduce_reference(x, w)
        errs[label] = _err(got, ref, BF16_TOL if dtype == torch.bfloat16
                           else F32_TOL, f"weighted_reduce {label}")
    # the FedOpt round's BatchNorm columns: a column range, row stride D
    xd, w = _inputs(10, d_main, torch.float32, "pos", gen, dev)
    out = torch.zeros(d_main, device=dev)
    got = epilogue.weighted_reduce(xd[:, p_main:], w, out=out[p_main:])
    torch.cuda.synchronize()
    check(got.data_ptr() == out[p_main:].data_ptr() and
          not bool(out[:p_main].any()), "weighted_reduce wrote outside out")
    errs["stats_cols"] = _err(got, epilogue.weighted_reduce_reference(
        xd[:, p_main:].contiguous(), w), F32_TOL, "weighted_reduce stats")
    phase(3, "kernels", "weighted_reduce vs plain version: " + ", ".join(
        f"{k} {v:.2e}" for k, v in errs.items())
        + f" (tolerance atol+rtol·|ref|: f32 {F32_TOL}, bf16 {BF16_TOL}); "
        f"main shape [10, {d_main}], stats columns [{p_main}, {d_main}) "
        f"at row stride {d_main}")

    ferrs = {}
    for case in _fused_cases(p_main, d_main):
        label, gdt = case[0], case[6]
        x, g, w, s, spec, st = _fused_inputs(case, gen, dev)
        got, got_st = epilogue.fused_epilogue(g, x, w, s, spec, _clone(st))
        torch.cuda.synchronize()
        ref, ref_st = epilogue.fused_epilogue_reference(g, x, w, s, spec,
                                                        _clone(st))
        tol = BF16_TOL if gdt == torch.bfloat16 else F32_TOL
        err = _err(got, ref, tol, f"fused_epilogue {label}")
        for k in ("m", "v"):
            if ref_st is not None and k in ref_st:
                err = max(err, _err(got_st[k], ref_st[k], F32_TOL,
                                    f"fused_epilogue {label} {k}"))
        check(ref_st is None or got_st.get("t") == ref_st.get("t"),
              f"fused_epilogue {label}: t")
        ferrs[label] = err
    phase(3, "kernels", "fused_epilogue vs plain version (max over out, m, "
          "v): " + ", ".join(f"{k} {v:.2e}" for k, v in ferrs.items())
          + f" (tolerance: f32 global {F32_TOL}, bf16 global {BF16_TOL}); "
          f"round shape: columns [0, {p_main}) of [10, {d_main}]")

    # the step's row read from a device table (step_rows), as the paths
    # launch it: adam's t by value (the per-round path) and from a device
    # tensor (the fused rounds), at t = 1, 2, 3 and 300; the other
    # channels' one row.  Held against the plain version with the step
    # rounded on the host, at the round shape
    cases = {c[0]: c for c in _fused_cases(p_main, d_main)}
    rerrs = {}
    for opt in CHANNELS:
        forms = (("device", "value") if opt == "adam" else ("table",))
        for t in ((1, 2, 3, 300) if opt == "adam" else (1,)):
            for form in forms:
                x, g, w, s_, spec, st = _fused_inputs(cases[f"round_{opt}"],
                                                      gen, dev)
                steps = epilogue.step_rows(s_, spec, 300, dev)
                ref_st = _clone(st)
                if opt == "adam":
                    ref_st["t"] = st["t"] = t - 1
                    if form == "device":
                        st["t"] = torch.tensor(t - 1, dtype=torch.int64,
                                               device=dev)
                got, got_st = epilogue.fused_epilogue(g, x, w, s_, spec, st,
                                                      steps=steps)
                torch.cuda.synchronize()
                ref, ref_st = epilogue.fused_epilogue_reference(
                    g, x, w, s_, spec, ref_st)
                label = f"{opt} t {t} {form}"
                err = _err(got, ref, F32_TOL, f"fused_epilogue {label}")
                for k in ("m", "v"):
                    if ref_st is not None and k in ref_st:
                        err = max(err, _err(got_st[k], ref_st[k], F32_TOL,
                                            f"fused_epilogue {label} {k}"))
                if opt == "adam":
                    check(int(got_st["t"]) == t, f"fused_epilogue {label}: "
                          f"t {got_st['t']}")
                rerrs[label] = err
    phase(3, "kernels", "fused_epilogue with the step's row from the device "
          "table vs plain version with the step rounded on the host (max "
          "over out, m, v; adam's t by value and from a device tensor): "
          + ", ".join(f"{k} {v:.2e}" for k, v in rerrs.items())
          + f" (tolerance {F32_TOL}); round shape")

    # the async fold at the main shape: the mix channel's path
    stale = torch.tensor([1.0, 0.5, 0.25, 1.0, 0.125, 0.5, 1.0, 0.5, 0.25,
                          1.0])
    wf = (stale * torch.randint(8, 64, (10,), generator=gen)).to(dev)
    g = torch.randn(d_main, generator=gen).to(dev)
    reset_launches()
    folded = fold_buffer({"flat": g}, {"flat": xd}, wf, 0.8)["flat"]
    torch.cuda.synchronize()
    fold_launches = read_launches()
    check(fold_launches["fused_epilogue.none"] == 1,
          f"fold_buffer launched {fold_launches}")
    ref, _ = epilogue.fused_epilogue_reference(g, xd, wf, 0.8)
    errs["fold"] = _err(folded, ref, F32_TOL, "fold_buffer")
    phase(3, "kernels", f"fold_buffer at [10, {d_main}], server_lr 0.8: "
          f"max |err| {errs['fold']:.2e} (tolerance {F32_TOL}), "
          f"launches {fold_launches['fused_epilogue.none']} "
          f"fused_epilogue.mix")
    max_err = {"weighted_reduce": max(errs["main_f32"], errs["stats_cols"])}
    for c in CHANNELS:
        max_err[c] = ferrs[f"round_{c}"]
    return p_main, d_main, max_err, fold_launches


#: (atol, rtol) of the flash kernel against its plain version: float32
#: sums in another order (the kernel's FMAs over key tiles against cuBLAS
#: products), the JAX package's own tolerance for its kernel; a bfloat16 o
#: at one to two bfloat16 steps, after rounding float32 values that differ
#: in their last bits
FLASH_F32_TOL = (2e-5, 2e-5)
FLASH_BF16_TOL = (1e-2, 1e-2)
#: the most of a bfloat16 o's values that may round to another bfloat16
#: value than the plain version's.  The tolerance above cannot see how o
#: was summed: one flipped rounding anywhere costs a bfloat16 step.  The
#: kernel's float32 o differs from the plain version's in its last bits
#: (sums in another order, p as high and low bfloat16 parts, equal to p
#: within 2^-16 of it), which moves a value across a rounding boundary
#: rarely; p rounded to bfloat16 alone errs by up to 2^-8 of each p, a
#: good part of a bfloat16 step of o, and moves a large share of them
#: (on an H100: 0.17-0.29 % of o's values against 34-37 %; PERF.md row 12).
FLASH_BF16_FLIPS = 0.01
#: the eval pass of the BERT-tiny path: batch 32, 2 heads, 80 tokens, head
#: dim 64, bfloat16, causal; and one at max_len, batch 8
LM_EVAL_SHAPE = (32, 2, 80, 64)
LM_LONG_SHAPE = (8, 2, 512, 64)
#: the fed-LLM path's eval pass: batch 4 (the aggregator's batch size), 2
#: heads of 64, sequences of 32, float32, causal
LLM_EVAL_SHAPE = (4, 2, 32, 64)


def _flash_qkv(b, h, t, d, dtype, gen, dev, tk=None):
    """q [b, h, t, d] and k, v [b, h, tk, d] as the model hands them to the
    kernel: [B, T, H, D] projections viewed as [B, H, T, D]."""
    return [torch.randn(b, n, h, d, generator=gen).to(dtype).to(dev)
            .transpose(1, 2) for n in (t, tk or t, tk or t)]


def _bf16_flips(got, ref):
    """The share of the elements of two bfloat16 tensors that differ."""
    return float((got != ref).float().mean())


def _flash_err(q, k, v, causal, t_valid, label, flips=None):
    """Max |err| of the kernel's o, l and m against the plain version's,
    checked against the tolerances; in bfloat16 also the share of o's
    values that differ (``flips[label]``), checked against
    ``FLASH_BF16_FLIPS``."""
    got = attn.flash_attention_residuals(q, k, v, causal, t_valid)
    torch.cuda.synchronize()
    ref = attn._reference_residuals(q, k, v, causal, t_valid)
    err = max(_err(g, r, FLASH_BF16_TOL if (name == "o" and q.dtype ==
                                            torch.bfloat16)
                   else FLASH_F32_TOL, f"flash_attention {label} {name}")
              for g, r, name in zip(got, ref, "olm"))
    if q.dtype == torch.bfloat16:
        share = _bf16_flips(got[0], ref[0])
        check(share <= FLASH_BF16_FLIPS,
              f"flash_attention {label} o: {share:.2%} of its bfloat16 "
              f"values differ from the plain version's (at most "
              f"{FLASH_BF16_FLIPS:.0%})")
        if flips is not None:
            flips[label] = share
    return err


def flash_kernel_phase(dev):
    """Kernel B12 against ``_reference_residuals`` on o, l and m: causal and
    not, T of 32, 80, 200 and 512, head dims 16, 32, 64 and 128, float32
    and bfloat16; T = 200 also padded to 256 with ``t_valid`` 200, as
    ``flash_attention`` pads it; keys of another length (160, and a ragged
    37) for 80 queries; q and k times 8, so the running max rescales often;
    ``t_valid`` of 0 (no key: l 0, m -1e30, o 0) and 1; a causal T of 97,
    a multiple of no tile; rows that do not start 16-byte aligned; and the
    eval shapes of the BERT-tiny path (bfloat16) and of the fed-LLM path
    (float32).  In bfloat16 each case also holds the
    share of o's values that round otherwise than the plain version's."""
    gen = torch.Generator().manual_seed(2)
    errs, flips = {}, {}

    def run(label, q, k, v, causal, t_valid):
        errs[label] = _flash_err(q, k, v, causal, t_valid, label, flips)

    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    for causal in (True, False):
        mode = "causal" if causal else "full"
        for t in (32, 80, 200, 512):
            for d in attn.HEAD_DIMS:
                for dt, dtype in dtypes.items():
                    label = f"{mode}_T{t}_D{d}_{dt}"
                    q, k, v = _flash_qkv(2, 2, t, d, dtype, gen, dev)
                    run(label, q, k, v, causal, t)
        q, k, v = _flash_qkv(2, 2, 256, 64, torch.float32, gen, dev)
        label = f"{mode}_T256_t_valid200_f32"
        run(label, q, k, v, causal, 200)
        for dt, dtype in dtypes.items():
            q, k, v = _flash_qkv(2, 2, 200, 64, dtype, gen, dev)
            label = f"{mode}_T200_qk_times8_{dt}"
            run(label, q * 8, k * 8, v, causal, 200)
            q, k, v = _flash_qkv(2, 2, 80, 64, dtype, gen, dev)
            for t_valid in (0, 1):
                label = f"{mode}_T80_t_valid{t_valid}_{dt}"
                run(label, q, k, v, causal, t_valid)
    for dt, dtype in dtypes.items():
        for tk in (160, 37):
            q, k, v = _flash_qkv(3, 2, 80, 64, dtype, gen, dev, tk=tk)
            run(f"full_T80_Tk{tk}_{dt}", q, k, v, False, tk)
        q, k, v = _flash_qkv(2, 2, 97, 64, dtype, gen, dev)
        for t_valid in (97, 70):
            label = f"causal_T97_t_valid{t_valid}_{dt}"
            run(label, q, k, v, True, t_valid)
    # rows not 16-byte aligned: the wrapper copies them for the tile loads
    q, k, v = (x[..., 1:] for x in _flash_qkv(2, 2, 80, 65, torch.bfloat16,
                                              gen, dev))
    run("causal_T80_misaligned_bf16", q, k, v, True, 80)
    q, k, v = _flash_qkv(*LLM_EVAL_SHAPE, torch.float32, gen, dev)
    run("causal_fed_llm_eval_shape_f32", q, k, v, True, LLM_EVAL_SHAPE[2])
    q, k, v = _flash_qkv(*LM_EVAL_SHAPE, torch.bfloat16, gen, dev)
    main = _flash_err(q, k, v, True, LM_EVAL_SHAPE[2], "eval shape", flips)
    worst = {dt: max(e for k_, e in errs.items() if k_.endswith(dt))
             for dt in dtypes}
    edge = {dt: max(e for k_, e in errs.items() if k_.endswith(dt) and (
        "times8" in k_ or "t_valid" in k_ or "Tk" in k_ or "T97" in k_))
        for dt in dtypes}
    phase(3, "kernels", f"flash_attention vs plain version, max |err| over "
          f"o, l, m: {len(errs)} cases (causal and full, T 32/80/200/512, D "
          f"{'/'.join(map(str, attn.HEAD_DIMS))}, f32 and bf16, T 256 at "
          f"t_valid 200, Tk 160 and 37 for T 80, q and k x 8, t_valid 0 "
          f"and 1, causal T 97, misaligned rows, the fed-LLM eval shape "
          f"{list(LLM_EVAL_SHAPE)} f32 causal): worst f32 "
          f"{worst['f32']:.2e}, worst bf16 {worst['bf16']:.2e}; edge cases "
          f"(Tk, x 8, t_valid, T 97) f32 {edge['f32']:.2e}, bf16 "
          f"{edge['bf16']:.2e}; eval shape {list(LM_EVAL_SHAPE)} bf16 causal "
          f"{main:.2e} (tolerance atol+rtol·|ref|: f32 and l, m "
          f"{FLASH_F32_TOL}, bf16 o {FLASH_BF16_TOL}); bf16 o values "
          f"rounded otherwise than the plain version's: worst "
          f"{max(flips.values()):.4%} ({max(flips, key=flips.get)}), eval "
          f"shape "
          f"{flips['eval shape']:.4%} (at most {FLASH_BF16_FLIPS:.0%})")
    return main


#: GPU clock cycles of ``torch.cuda._sleep`` that keep the card busy for
#: about a millisecond while the host enqueues a call whose host work
#: outlasts the cache flush (~0.085 ms)
HIDE_CYCLES = 2_000_000


def _time_ms(fn, flush, n=50, warmup=5, hide=False,
             hide_cycles=HIDE_CYCLES):
    """Median device time of ``fn`` over ``n`` calls, each on a cold L2:
    a 256 MB write precedes every call (the round's reduce reads client
    rows written long before), and keeps the card busy while the host
    enqueues the call, so host overhead does not enter the interval; with
    ``hide`` a GPU sleep of ``hide_cycles`` follows the write, for calls
    whose host work outlasts it."""
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    for s, e in zip(starts, ends):
        flush.zero_()
        if hide:
            torch.cuda._sleep(hide_cycles)
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


#: float32 operations per column after the reduce, by channel (sub, mul,
#: add, div, sqrt each one)
CHANNEL_OPS = {"none": 3, "sgd": 4, "momentum": 6, "adam": 16}


def _bound(nbytes, ops, card, peak="f32"):
    """The least time in ms for ``nbytes`` at the memory rate and ``ops``
    at the card's float32 (``peak="f32"``) or dense bfloat16 tensor-core
    (``"bf16"``) rate, and which of the two it is."""
    bw, f32, bf16 = card_peaks(card)
    flops = bf16 if peak == "bf16" else f32
    t_bytes, t_ops = nbytes / bw * 1e3, ops / flops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def timing_phase(dev, p_main, d_main, card):
    c = 10
    gen = torch.Generator().manual_seed(1)
    x, w = _inputs(c, d_main, torch.float32, "pos", gen, dev)
    wn = w / torch.clamp(w.sum(), min=1e-12)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    # plain, kernel, kernel, plain
    plain_ms = _time_ms(lambda: epilogue.weighted_reduce_reference(x, w),
                        flush, hide=True)
    kernel_ms = _time_ms(lambda: epilogue.weighted_reduce(x, w), flush,
                         hide=True)
    library_ms = _time_ms(lambda: torch.matmul(wn, x), flush, hide=True)
    kernel_ms_2 = _time_ms(lambda: epilogue.weighted_reduce(x, w), flush,
                           hide=True)
    plain_ms_2 = _time_ms(lambda: epilogue.weighted_reduce_reference(x, w),
                          flush, hide=True)
    nbytes = c * d_main * 4 + d_main * 4 + c * 4
    bound_ms, bound_by = _bound(nbytes, 2 * c * d_main, card)
    out = {"weighted_reduce": dict(
        ms=statistics.median([kernel_ms, kernel_ms_2]),
        plain_ms=statistics.median([plain_ms, plain_ms_2]),
        library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)}
    phase(4, "timing", f"weighted_reduce at [10, {d_main}] f32, cold L2, "
          f"host hidden, median of 50: kernel {kernel_ms:.4f} / "
          f"{kernel_ms_2:.4f} ms, "
          f"plain {plain_ms:.4f} / {plain_ms_2:.4f} ms, library "
          f"matmul(wn, x) {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by}: {nbytes / 1e6:.2f} MB at "
          f"{card_peaks(card)[0] / 1e12:.2f} TB/s) -> "
          f"{bound_ms / kernel_ms:.1%} of the bound")

    # each channel on the FedOpt round's parameter columns at s = 1, the
    # mixing rate of the Parrot path.  mix and sgd are affine in g and the
    # reduce, (1 − a)·g + a·(wn·x) with a = s and lr·s: one addmv (a cuBLAS
    # gemv over the column range) computes each.  momentum and adam also
    # update their state, which no single PyTorch call does: no library time
    cols = x[:, :p_main]
    g = torch.randn(p_main, generator=gen).to(dev)
    res = torch.empty_like(g)
    lib_res = torch.empty_like(g)
    for opt in CHANNELS:
        spec = epilogue.EpilogueSpec(opt=opt, lr=1e-3)
        st = epilogue.init_opt_state(g, spec)
        if st is not None:
            st["m"].normal_()
            if "v" in st:
                st["v"].uniform_()
                st["t"] = 4
        st_plain = _clone(st)
        steps = epilogue.step_rows(1.0, spec, 4096, dev)
        st_dev = _clone(st)
        if st_dev is not None and "t" in st_dev:
            st_dev["t"] = torch.tensor(4, dtype=torch.int64, device=dev)

        def kernel():
            # the per-round path's launch: the step by value, its row read
            # from the device table
            epilogue.fused_epilogue(g, cols, w, 1.0, spec, st, out=res,
                                    steps=steps)

        def kernel_dev():
            # the fused rounds' launch: the count advanced on the device
            # (one add) and read by the kernel
            epilogue.fused_epilogue(g, cols, w, 1.0, spec, st_dev, out=res,
                                    steps=steps)

        def plain():
            epilogue.fused_epilogue_reference(g, cols, w, 1.0, spec,
                                              st_plain)

        lib_ms, lib_note = None, ("none (no single PyTorch call also "
                                  "updates the optimizer state)")
        if opt in ("none", "sgd"):
            a = 1.0 if opt == "none" else spec.lr

            def library():
                torch.addmv(g, cols.t(), wn, beta=1.0 - a, alpha=a,
                            out=lib_res)

            library()
            ref, _ = epilogue.fused_epilogue_reference(g, cols, w, 1.0, spec)
            lib_err = _err(lib_res, ref, (1e-5, 1e-5), f"addmv for {opt}")
            lib_ms = _time_ms(library, flush, hide=True)
            lib_note = (f"addmv(g, x.t(), wn, beta={1.0 - a:g}, alpha={a:g})"
                        f" {lib_ms:.4f} ms (vs plain max |err| "
                        f"{lib_err:.2e})")
        p1 = _time_ms(plain, flush, hide=True)
        k1 = _time_ms(kernel, flush, hide=True)
        dev_note = ""
        if opt == "adam":
            d1 = _time_ms(kernel_dev, flush, hide=True)
        k2 = _time_ms(kernel, flush, hide=True)
        if opt == "adam":
            d2 = _time_ms(kernel_dev, flush, hide=True)
            dev_note = (f", the fused rounds' launch (t on the device, its "
                        f"add included) {d1:.4f} / {d2:.4f} ms")
        p2 = _time_ms(plain, flush, hide=True)
        streams = {"none": 0, "sgd": 0, "momentum": 2, "adam": 4}[opt]
        nbytes = (c + 2 + streams) * p_main * 4 + c * 4
        bound_ms, bound_by = _bound(
            nbytes, (2 * c + CHANNEL_OPS[opt]) * p_main, card)
        ms = statistics.median([k1, k2])
        out[opt] = dict(ms=ms, plain_ms=statistics.median([p1, p2]),
                        library_ms=lib_ms, bound_ms=bound_ms,
                        bound_by=bound_by)
        phase(4, "timing", f"fused_epilogue.{opt if opt != 'none' else 'mix'}"
              f" at columns [0, {p_main}) of [10, {d_main}] f32, cold L2, "
              f"host hidden, median of 50: kernel (the step's row from the "
              f"device table) {k1:.4f} / {k2:.4f} ms{dev_note}, plain "
              f"{p1:.4f} / {p2:.4f} ms, library {lib_note}, bound "
              f"{bound_ms:.4f} ms ({bound_by}: {nbytes / 1e6:.2f} MB) -> "
              f"{bound_ms / ms:.1%} of the bound")
    return out


def flash_timing_phase(dev, card):
    """Kernel B12 at the BERT-tiny path's eval shape and at max_len, bf16,
    causal, and at the fed-LLM path's eval shape in float32, on the model's
    [B, T, H, D] views; its plain version; and
    ``scaled_dot_product_attention(q, k, v, is_causal=True)`` in the same
    dtype, timed only.  The bound: q, k, v read and o, l, m written once,
    against the causal half of both products (2·D·T·(T+1) operations per
    head, the diagonal included) at the dense bfloat16 tensor-core rate,
    or for float32 at the CUDA cores' float32 rate."""
    from torch.nn.functional import scaled_dot_product_attention

    gen = torch.Generator().manual_seed(4)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    rows = {}
    for shape, dtype in ((LM_EVAL_SHAPE, torch.bfloat16),
                         (LM_LONG_SHAPE, torch.bfloat16),
                         (LLM_EVAL_SHAPE, torch.float32)):
        b, h, t, d = shape
        q, k, v = _flash_qkv(b, h, t, d, dtype, gen, dev)
        bf16 = dtype == torch.bfloat16

        def kernel():
            attn.flash_attention_residuals(q, k, v, True)

        def plain():
            attn._reference_residuals(q, k, v, True)

        def library():
            return scaled_dot_product_attention(q, k, v, is_causal=True)

        lib_err = _err(library(), attn._reference(q, k, v, True),
                       FLASH_BF16_TOL if bf16 else FLASH_F32_TOL,
                       "scaled_dot_product_attention")
        # the host's work for a call (the wrapper's checks and allocations)
        # can outlast the cache flush on a loaded host: a GPU sleep hides it
        p1 = _time_ms(plain, flush, hide=True)
        k1 = _time_ms(kernel, flush, hide=True)
        lib_ms = _time_ms(library, flush, hide=True)
        k2 = _time_ms(kernel, flush, hide=True)
        p2 = _time_ms(plain, flush, hide=True)
        nbytes = 4 * b * h * t * d * q.element_size() + 2 * b * h * t * 4
        ops = 2 * b * h * d * t * (t + 1)
        peak = "bf16" if bf16 else "f32"
        bound_ms, bound_by = _bound(nbytes, ops, card, peak=peak)
        ms = statistics.median([k1, k2])
        rows[shape] = dict(ms=ms, plain_ms=statistics.median([p1, p2]),
                           library_ms=lib_ms, bound_ms=bound_ms,
                           bound_by=bound_by)
        rate = card_peaks(card)[2 if bf16 else 1] / 1e12
        phase(4, "timing", f"flash_attention at {list(shape)} {peak} causal "
              f"([B, T, H, D] views), cold L2, host hidden, median of 50: "
              f"kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms, "
              f"library scaled_dot_product_attention {lib_ms:.4f} ms (vs "
              f"plain max |err| {lib_err:.2e}), bound {bound_ms:.5f} ms "
              f"({bound_by}: {nbytes / 1e6:.3f} MB at "
              f"{card_peaks(card)[0] / 1e12:.2f} TB/s, {ops / 1e6:.1f} MFLOP "
              f"at {rate:.0f} TFLOP/s {'dense bf16' if bf16 else 'f32'}) -> "
              f"{bound_ms / ms:.1%} of the bound")
    return rows[LM_EVAL_SHAPE]


def _wire_vector(d, gen):
    """float32 [d] whose 512-value rows cycle through the unit tests'
    kinds: random, all zero, values on .5 after scaling (max 127, so scale
    1), max below 1e-30, above 1e30, all negative, a NaN among random
    values, +inf and -inf among random values (a diverged update: the
    scale NaN or inf, the row decoded to NaN)."""
    x = torch.randn(d, generator=gen)
    for r in range(-(-d // wc.BLOCK)):
        lo, hi = r * wc.BLOCK, min(d, (r + 1) * wc.BLOCK)
        kind = (r + d) % 8
        if kind == 1:
            x[lo:hi] = 0.0
        elif kind == 2:
            v = torch.randint(-126, 127, (hi - lo,), generator=gen) + 0.5
            v[0] = 127.0
            x[lo:hi] = v
        elif kind == 3:
            x[lo:hi] *= 1e-33
        elif kind == 4:
            x[lo:hi] *= 1e35
        elif kind == 5:
            x[lo:hi] = -x[lo:hi].abs()
        elif kind == 6:
            x[lo + (hi - lo) // 2] = float("nan")
        elif kind == 7:
            x[lo] = float("inf")
            x[hi - 1] = -float("inf")
    return x


def resnet56_wire_lengths():
    """ResNet-56's wire tree, one segment per leaf (287) in wire order: the
    segment table of every broadcast of the cross-silo path."""
    tree = tree_from_module(CIFARResNet(depth=56, num_classes=10))
    return [leaf.numel() for leaf in tree_leaves(tree)]


def _wire_plain(x, lengths):
    """The plain versions on the card, segment by segment."""
    qs, ss, outs, off = [], [], [], 0
    for n in lengths or [x.numel()]:
        q, s = wc.quantize_int8_reference(x[off:off + n])
        qs.append(q)
        ss.append(s)
        outs.append(wc.dequantize_int8_reference(q, s, n))
        off += n
    return torch.cat(qs), torch.cat(ss), torch.cat(outs)


def _same_bits(got, want, label):
    """Equal bits, where a NaN matches a NaN of any payload; the max |err|
    of the finite values."""
    check(got.dtype == want.dtype and got.shape == want.shape,
          f"{label}: kernel gave {got.dtype} {tuple(got.shape)}, plain "
          f"version {want.dtype} {tuple(want.shape)}")
    if want.is_floating_point():
        nan = want.isnan()
        check(torch.equal(got.isnan(), nan),
              f"{label}: kernel and plain version have NaNs in different "
              f"places ({int(got.isnan().sum())} and {int(nan.sum())})")
        got, want = got[~nan], want[~nan]
    check(torch.equal(got.view(torch.uint8), want.view(torch.uint8)),
          f"{label}: kernel and plain version differ in "
          f"{int((got != want).sum())} values")
    diff = (got.float() - want.float()).abs()
    diff = diff[diff.isfinite()]
    return float(diff.max()) if diff.numel() else 0.0


def wire_kernel_phase(dev):
    """The quantize and dequantize kernels against their plain versions,
    bit for bit: the unit-test sizes, ResNet-56's whole flat vector as one
    segment (the uplink), and its 287 leaves as a segment table in one
    launch (the broadcast)."""
    gen = torch.Generator().manual_seed(5)
    lengths = resnet56_wire_lengths()
    d_main = sum(lengths)
    cases = [(f"D={d}", d, None) for d in (1, 511, 512, 513, 32 * 512 + 7,
                                           100_000)]
    # past the by-value capacity (2,048 scale rows): 2,100 one-row leaves
    past = [1 + i % 3 for i in range(2100)]
    cases += [("resnet56_flat", d_main, None),
              ("resnet56_leaves", d_main, lengths),
              ("past_capacity", sum(past), past)]
    errs = {"wire_compression.quantize": 0.0,
            "wire_compression.dequantize": 0.0}
    forms = {}
    for label, d, lens in cases:
        x = _wire_vector(d, gen).to(dev)
        before = dict(wc.LAUNCHES)
        form_before = dict(wc.DEQUANT_FORMS)
        qform_before = dict(wc.QUANT_FORMS)
        q, s = wc.quantize_int8_blocked(x, lens)
        out = wc.dequantize_int8_blocked(q, s, d, lens)
        torch.cuda.synchronize()
        check(wc.LAUNCHES["quantize"] == before["quantize"] + 1
              and wc.LAUNCHES["dequantize"] == before["dequantize"] + 1,
              f"wire kernels {label}: one launch each, got {wc.LAUNCHES}")
        form = wc.dequantize_form(lens or [d])
        check(wc.DEQUANT_FORMS[form] == form_before[form] + 1
              and wc.QUANT_FORMS[form] == qform_before[form] + 1,
              f"wire kernels {label}: not the {form} form")
        forms[form] = forms.get(form, 0) + 1
        want_q, want_s, want = _wire_plain(x, lens)
        errs["wire_compression.quantize"] = max(
            errs["wire_compression.quantize"],
            _same_bits(q, want_q, f"quantize {label} q"),
            _same_bits(s, want_s, f"quantize {label} scales"))
        errs["wire_compression.dequantize"] = max(
            errs["wire_compression.dequantize"],
            _same_bits(out, want, f"dequantize {label}"))
    phase(3, "kernels", f"wire_compression quantize and dequantize vs plain "
          f"versions, bit for bit (q, scales, dequantized values; rows "
          f"random, zero, on .5, below 1e-30, above 1e30, negative, with a "
          f"NaN, with +inf and -inf): "
          f"{', '.join(c[0] for c in cases)} ({len(lengths)} segments, D "
          f"{d_main}), one launch each per call, both kernels' forms "
          f"{forms}; max |err| "
          f"{errs['wire_compression.quantize']:.1e} / "
          f"{errs['wire_compression.dequantize']:.1e} (tolerance: equal "
          f"bits)")
    return errs


#: (d_in, d_out) of TinyTransformerLM's five LoRA targets: BERT-tiny's
#: adapter table is their ``a`` [d_in, r] and ``b`` [r, d_out], 10 leaves
LORA_TARGETS = [(128, 90), (128, 512), (512, 128), (128, 512), (512, 128)]


def _adapter_tree(rank, dtype, dev, gen, misalign=0):
    """BERT-tiny's adapter table at ``rank`` and a float32 delta of the same
    shapes, each a tree of views into one buffer, as the fed-LLM plane holds
    them; ``misalign`` starts the adapters' buffer that many values in, so
    no leaf is 16-byte aligned.  Also the flat buffers."""
    shapes = []
    for i, (d_in, d_out) in enumerate(LORA_TARGETS):
        shapes += [(f"t{i}", "a", (d_in, rank)),
                   (f"t{i}", "b", (rank, d_out))]
    total = sum(math.prod(sh) for _, _, sh in shapes)
    a_buf = (torch.randn(total + misalign, generator=gen) * 0.01).to(
        dtype).to(dev)
    d_buf = (torch.randn(total, generator=gen) * 1e-3).to(dev)
    a, d, off = {}, {}, 0
    for path, k, sh in shapes:
        n = math.prod(sh)
        a.setdefault(path, {})[k] = a_buf[misalign + off:
                                          misalign + off + n].view(sh)
        d.setdefault(path, {})[k] = d_buf[off:off + n].view(sh)
        off += n
    return a, d, a_buf[misalign:], d_buf


def _lora_sizes(rank):
    """The values of BERT-tiny's 10 adapter leaves at ``rank``."""
    return [n for d_in, d_out in LORA_TARGETS
            for n in (d_in * rank, rank * d_out)]


def _gapped_tree(sizes, gap, dtype, dev, gen):
    """Adapter leaves of ``sizes`` values in one buffer, back to back, and
    a float32 delta whose leaves lie ``gap`` values apart in theirs: a
    layout that is no flat range."""
    a_buf = (torch.randn(sum(sizes), generator=gen) * 0.01).to(dtype).to(dev)
    d_buf = (torch.randn(sum(sizes) + gap * len(sizes), generator=gen)
             * 1e-3).to(dev)
    a, d, off = [], [], 0
    for i, n in enumerate(sizes):
        a.append(a_buf[off:off + n])
        d.append(d_buf[off + gap * i:off + gap * i + n])
        off += n
    return a, d


def _tied_delta(seed):
    """4,096 float32 values of four magnitudes with random signs: the k-th
    largest |x| of ``topk:0.1`` falls inside a run of ties."""
    gen = torch.Generator().manual_seed(seed)
    mags = torch.tensor([0.5, 0.25, 2.0 ** -6, 2.0 ** -10])
    sign = torch.where(torch.rand(4096, generator=gen) < 0.5, -1.0, 1.0)
    return mags[torch.randint(0, 4, (4096,), generator=gen)] * sign


def fold_kernel_phase(dev):
    """Kernel B6 against ``fold_delta_reference`` on the card, bit for bit:
    float32 and bfloat16 adapters, ``server_lr`` 0, 1 and 0.37, on
    BERT-tiny's 10-leaf rank-4 table (11,112 values), rank-3 leaves (no
    multiples of 4) and a misaligned buffer; one launch each.  Then top-k
    selection on ties, the card against the CPU (which the CPU tests hold
    to ``jax.lax.top_k``): indices, values and the error-feedback residual
    of ``topk:0.1`` and ``topk8:0.1`` over three encodes, bit for bit."""
    gen = torch.Generator().manual_seed(8)
    err, n = 0.0, 0
    for label, rank, mis in (("rank4", 4, 0), ("rank3", 3, 0),
                             ("misaligned", 4, 1)):
        for dt in (torch.float32, torch.bfloat16):
            for lr in (0.0, 1.0, 0.37):
                a, d, _, _ = _adapter_tree(rank, dt, dev, gen, mis)
                before = epilogue.LAUNCHES["fold_delta"]
                got = epilogue.fold_delta(a, d, lr)
                torch.cuda.synchronize()
                check(epilogue.LAUNCHES["fold_delta"] == before + 1,
                      f"fold_delta {label}: one launch, got "
                      f"{epilogue.LAUNCHES['fold_delta'] - before}")
                want = epilogue.fold_delta_reference(a, d, lr)
                for g, w in zip(tree_leaves(got), tree_leaves(want)):
                    err = max(err, _same_bits(g, w, f"fold_delta {label} "
                                              f"{dt} lr {lr}"))
                n += 1
    a, d, _, _ = _adapter_tree(4, torch.float32, dev, gen)
    want = epilogue.fold_delta_reference(a, d, 0.37)
    epilogue.fold_delta(a, d, 0.37, out=a)
    torch.cuda.synchronize()
    for g, w in zip(tree_leaves(a), tree_leaves(want)):
        _same_bits(g, w, "fold_delta in place")
    # both launch forms of fold_plan: the cases above are one flat range;
    # a delta with gaps between its leaves, BERT-tiny's 10 or 120 others,
    # takes the device table
    n_table = 0
    for sizes, gap in ((_lora_sizes(4), 3),
                       ([1 + (97 * i) % 700 for i in range(120)], 5)):
        for dt in (torch.float32, torch.bfloat16):
            a, d = _gapped_tree(sizes, gap, dt, dev, gen)
            for out in (None, a):
                want = epilogue.fold_delta_reference(a, d, 0.37)
                before = dict(epilogue.FOLD_FORMS)
                got = epilogue.fold_delta(a, d, 0.37, out=out)
                torch.cuda.synchronize()
                took = [k for k, v in epilogue.FOLD_FORMS.items()
                        if v != before[k]]
                check(took == ["table"], f"fold_delta with gaps {dt}: took "
                      f"the launch forms {took}")
                for g, w in zip(tree_leaves(got), tree_leaves(want)):
                    err = max(err, _same_bits(g, w, f"fold_delta table "
                                              f"{dt}"))
                n_table += 1
    phase(3, "kernels", f"fold_delta vs plain version, bit for bit: {n} "
          f"cases (rank 4: BERT-tiny's 10 leaves, 11,112 values; rank 3; a "
          f"misaligned buffer; f32 and bf16 adapters; server_lr 0, 1, 0.37) "
          f"and one in place, all one flat range; {n_table} in the table "
          f"form (a delta with gaps: BERT-tiny's 10 leaves and 120 others; "
          f"f32 and bf16, new buffer and in place); one launch per call; "
          f"max |err| {err:.1e} (tolerance: equal bits)")
    x = _tied_delta(7)
    got_v, got_i = wc.topk_select(x.to(dev), 409)
    want_v, want_i = wc.topk_select(x, 409)
    _same_bits(got_i.cpu(), want_i, "topk ties indices")
    _same_bits(got_v.cpu(), want_v, "topk ties values")
    for spec in ("topk:0.1", "topk8:0.1"):
        on_card, on_cpu = WireCodec(spec), WireCodec(spec)
        ref = {"w": torch.zeros(4096)}
        for step in range(3):
            update = {"w": _tied_delta(8 + step)}
            got = on_card.encode_delta(tree_map(lambda t: t.to(dev), update),
                                       tree_map(lambda t: t.to(dev), ref))
            want = on_cpu.encode_delta(update, ref)
            for k in ("idx", "values", "values_q", "scales"):
                if k in want:
                    _same_bits(got[k].cpu(), want[k], f"{spec} {k}")
            _same_bits(on_card._residual.cpu(), on_cpu._residual,
                       f"{spec} residual")
    phase(3, "kernels", "top-k on ties (4,096 values of four magnitudes, k "
          "409): card indices and values equal the CPU's, and topk:0.1 / "
          "topk8:0.1 payloads and error-feedback residuals over 3 encodes "
          "(tolerance: equal bits)")
    return err


def wire_timing_phase(dev, card):
    """Both wire kernels at ResNet-56's flat D (the uplink's one segment),
    cold L2: kernel, plain version and, for the dequantize,
    ``torch.mul(q_rows, scales[:, None])`` on the ``[R, 512]`` view of a
    padded q (one call, int8 × float32 promoting to float32).  The
    quantize has no library call: no single PyTorch call derives each
    row's scale and its rounded values (``torch.quantize_per_channel``
    takes the scales as input, divides, and clamps to −128).  Also, for
    the record, both kernels over the broadcast's 287-segment table."""
    lengths = resnet56_wire_lengths()
    d = sum(lengths)
    rows = -(-d // wc.BLOCK)
    gen = torch.Generator().manual_seed(6)
    x = (torch.randn(d, generator=gen) * 1e-2).to(dev)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    q, s = wc.quantize_int8_blocked(x)
    q_rows = torch.zeros(rows * wc.BLOCK, dtype=torch.int8, device=dev)
    q_rows[:d] = q
    q_rows = q_rows.view(rows, wc.BLOCK)
    lib = torch.mul(q_rows, s[:, None])
    check(lib.dtype == torch.float32, f"torch.mul gave {lib.dtype}")
    _same_bits(lib.reshape(-1)[:d], wc.dequantize_int8_reference(q, s, d),
               "torch.mul(q_rows, scales[:, None])")
    out = {}
    for name, kernel, plain, library, nbytes, ops in (
            ("wire_compression.quantize",
             lambda: wc.quantize_int8_blocked(x),
             lambda: wc.quantize_int8_reference(x), None,
             4 * d + d + 4 * rows, 6 * d + 2 * rows),
            ("wire_compression.dequantize",
             lambda: wc.dequantize_int8_blocked(q, s, d),
             lambda: wc.dequantize_int8_reference(q, s, d),
             lambda: torch.mul(q_rows, s[:, None]),
             d + 4 * rows + 4 * d, d)):
        p1 = _time_ms(plain, flush, hide=True)
        k1 = _time_ms(kernel, flush, hide=True)
        lib_ms = (_time_ms(library, flush, hide=True) if library is not None
                  else None)
        k2 = _time_ms(kernel, flush, hide=True)
        p2 = _time_ms(plain, flush, hide=True)
        bound_ms, bound_by = _bound(nbytes, ops, card)
        ms = statistics.median([k1, k2])
        out[name] = dict(ms=ms, plain_ms=statistics.median([p1, p2]),
                         library_ms=lib_ms, bound_ms=bound_ms,
                         bound_by=bound_by)
        lib_note = (f"torch.mul(q_rows, scales[:, None]) {lib_ms:.4f} ms"
                    if lib_ms is not None else
                    "none (no single PyTorch call derives the scales and "
                    "the rounded values)")
        phase(4, "timing", f"{name} at D {d} (one segment), cold L2, host "
              f"hidden, median of 50: kernel {k1:.4f} / {k2:.4f} ms, plain "
              f"{p1:.4f} / "
              f"{p2:.4f} ms, library {lib_note}, bound {bound_ms:.5f} ms "
              f"({bound_by}: {nbytes / 1e6:.3f} MB at "
              f"{card_peaks(card)[0] / 1e12:.2f} TB/s) -> "
              f"{bound_ms / ms:.1%} of the bound")
    qs, ss = wc.quantize_int8_blocked(x, lengths)
    tq = _time_ms(lambda: wc.quantize_int8_blocked(x, lengths), flush,
                  hide=True)
    td = _time_ms(lambda: wc.dequantize_int8_blocked(qs, ss, d, lengths),
                  flush, hide=True)
    phase(4, "timing", f"wire kernels over the broadcast's {len(lengths)} "
          f"segments ({ss.numel()} scales; both in the "
          f"{wc.quantize_form(lengths)} form), cold L2, "
          f"host hidden, median of 50: quantize {tq:.4f} ms, dequantize "
          f"{td:.4f} ms")
    return out, codec_host_phase(dev)


def fold_timing_phase(dev, card):
    """Kernel B6 at the fed-LLM path's shape: BERT-tiny's rank-4 adapters,
    11,112 float32 values over 10 leaves, ``server_lr`` 1, cold L2, median
    of 50: kernel, plain version (4 ops a leaf) and
    ``torch.add(a, d, alpha=lr)`` on the flat buffers, timed only — each
    with a GPU sleep ahead of it, since the wrapper's host work (the trees'
    walk, the leaf table, the output views) outlasts the cache flush.  The
    whole call, host work included, is timed apart on the host clock.  The
    bound: a and d read and the result written once (12 bytes a value)
    against two float32 operations a value."""
    gen = torch.Generator().manual_seed(9)
    a, d, a_flat, d_flat = _adapter_tree(4, torch.float32, dev, gen)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    lib = torch.add(a_flat, d_flat, alpha=1.0)
    flat = epilogue.FOLD_FORMS["flat"]
    got = epilogue.fold_delta(a, d, 1.0)
    check(epilogue.FOLD_FORMS["flat"] == flat + 1,
          f"fold_delta at the fed-LLM shape took {epilogue.FOLD_FORMS}, not "
          f"the flat form")
    lib_err = _same_bits(lib, torch.cat([t.reshape(-1) for t in
                                         tree_leaves(got)]),
                         "torch.add(a, d, alpha=1) vs the fold")

    def kernel():
        epilogue.fold_delta(a, d, 1.0)

    def plain():
        epilogue.fold_delta_reference(a, d, 1.0)

    def library():
        torch.add(a_flat, d_flat, alpha=1.0)

    p1 = _time_ms(plain, flush, hide=True)
    k1 = _time_ms(kernel, flush, hide=True)
    lib_ms = _time_ms(library, flush, hide=True)
    k2 = _time_ms(kernel, flush, hide=True)
    p2 = _time_ms(plain, flush, hide=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        kernel()
    torch.cuda.synchronize()
    call_ms = (time.perf_counter() - t0) / 200 * 1e3
    n = a_flat.numel()
    nbytes = 12 * n
    bound_ms, bound_by = _bound(nbytes, 2 * n, card)
    ms = statistics.median([k1, k2])
    phase(4, "timing", f"fold_delta at BERT-tiny's rank-4 adapters ({n} "
          f"f32 values, {len(tree_leaves(a))} leaves, one launch, one flat "
          f"range), cold L2, "
          f"a GPU sleep ahead of each call, median of 50: kernel {k1:.4f} / "
          f"{k2:.4f} ms, plain (4 ops a leaf) {p1:.4f} / {p2:.4f} ms, "
          f"library torch.add(a, d, alpha=1) {lib_ms:.4f} ms (vs the kernel "
          f"max |err| {lib_err:.1e}), bound {bound_ms:.6f} ms ({bound_by}: "
          f"{nbytes / 1e3:.1f} kB at {card_peaks(card)[0] / 1e12:.2f} TB/s) "
          f"-> {bound_ms / ms:.2%} of the bound; the whole call with its "
          f"host work {call_ms:.4f} ms (host clock, 200 calls)")
    return dict(ms=ms, plain_ms=statistics.median([p1, p2]),
                library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by)


def codec_host_phase(dev):
    """The wire codec's whole calls on ResNet-56's tree on the card — host
    work and launches, one thread, host clock over 20 calls ending in a
    synchronize — and what one round of the cross-silo path makes of
    them: one ``encode_model`` and ``SILOS + 1`` ``decode_model`` (the
    server's and each silo's), ``SILOS`` ``encode_delta`` and ``SILOS``
    ``decode_delta``.  Returns that per-round sum in seconds."""
    tree = tree_map(lambda t: t.to(dev), tree_from_module(
        CIFARResNet(depth=56, num_classes=10)))
    enc = WireCodec.encode_model(tree)
    ref = WireCodec.decode_model(enc)
    codec = WireCodec("int8")
    payload = codec.encode_delta(tree, ref)

    def host_ms(fn, n=20):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    ms = {"encode_model": host_ms(lambda: WireCodec.encode_model(tree)),
          "decode_model": host_ms(lambda: WireCodec.decode_model(enc)),
          "encode_delta": host_ms(lambda: codec.encode_delta(tree, ref)),
          "decode_delta": host_ms(lambda: decode_delta(payload, ref))}
    per_round = (ms["encode_model"] + (SILOS + 1) * ms["decode_model"]
                 + SILOS * (ms["encode_delta"] + ms["decode_delta"]))
    phase(4, "timing", f"wire codec per call on ResNet-56's "
          f"{len(tree_leaves(tree))}-leaf tree, one thread, host clock "
          f"ending in a synchronize: " + ", ".join(
              f"{k} {v:.2f} ms" for k, v in ms.items())
          + f"; one round of {SILOS} silos makes {per_round:.1f} ms of it")
    return per_round / 1e3


def _small_round(device, **kw):
    """One uniform Parrot round of a ResNet-8 in float32 on ``device``,
    from the same seeded variables: the global model as a flax tree, the
    final metrics and the API."""
    args = fedml_tpu_torch.Config(
        dataset="cifar10", backend="parrot", client_num_in_total=4,
        client_num_per_round=2, comm_round=1, batch_size=16,
        learning_rate=0.05, data_scale=0.02, compute_dtype="float32",
        frequency_of_the_test=1,
        data_cache_dir=os.path.join(ROOT, ".data_cache", "chip_smoke_small"),
        **kw)
    dataset = fedml_tpu_torch.data.load(args)
    module = CIFARResNet(depth=8, num_classes=10,
                         generator=torch.Generator().manual_seed(0))
    api = ParrotAPI(args, device, dataset,
                    ModelBundle(module, (32, 32, 3), 10))
    final = api.train()
    return api.global_flax_variables(), final, api


def _flat_tree(tree, coll):
    out = []

    def walk(t):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        else:
            out.append(np.asarray(t, np.float32).ravel())

    walk(tree[coll])
    return np.concatenate(out)


#: the card rounds of the parity phase: (label, config, channel, weighted
#: reduces per dtype group)
PARITY = [
    ("FedAvg", {}, None, 1),
    ("FedOpt adam", dict(FEDOPT), "adam", 1),
    ("FedOpt sgd momentum 0.9", dict(federated_optimizer="FedOpt",
                                     server_optimizer="sgd", server_lr=0.5,
                                     server_momentum=0.9), "momentum", 1),
    ("FedOpt sgd", dict(federated_optimizer="FedOpt", server_optimizer="sgd",
                        server_lr=0.5, server_momentum=0.0), "sgd", 1),
    ("FedProx", dict(federated_optimizer="FedProx"), None, 1),
    ("FedNova", dict(federated_optimizer="FedNova"), None, 2),
    ("SCAFFOLD", dict(federated_optimizer="SCAFFOLD"), None, 2),
    ("FedDyn", dict(federated_optimizer="FedDyn"), None, 1),
    ("Mime", dict(federated_optimizer="Mime"), None, 2),
]
#: per round and dtype group, the weighted reduces of each arm's server
#: step: the model, plus FedNova's nova_d, SCAFFOLD's c_delta, Mime's
#: full_grad
ARM_REDUCES = {"FedProx": 1, "FedNova": 2, "SCAFFOLD": 2, "FedDyn": 1,
               "Mime": 2}


def _state_bound(name, api, tol=1e-3):
    """Card-vs-CPU bound of server state ``name`` from the variables'
    ``tol`` (``tests/test_torch_parrot_algorithms.py``'s derivation):
    SCAFFOLD's variates are parameter moves over τ·lr (τ the fewest steps of
    a client), FedDyn's state α times parameter moves, Mime's momentum
    (1 − β) times a mean of gradients (a gradient's bound is the
    variables' over lr)."""
    lr = float(api.args.learning_rate)
    tau = min(-(-api.local_num_dict[c] // api.bs)
              for c in range(api.n_total))
    return {"c_locals": tol / (tau * lr), "c_global": tol / (tau * lr),
            "lambdas": tol * float(api.args.feddyn_alpha),
            "h": tol * float(api.args.feddyn_alpha),
            "momentum": tol / lr * (1 - float(api.args.server_momentum))
            }[name]


def _state_diffs(gpu_api, cpu_api):
    """Per server-state entry of the arm (not FedOpt's): (max |card − CPU|,
    bound)."""
    out = {}
    for name, groups in gpu_api.server_state.items():
        if name == "opt_state":
            continue
        diff = max(float((t.cpu() - cpu_api.server_state[name][dt]).abs()
                         .max()) for dt, t in groups.items())
        out[name] = (diff, _state_bound(name, gpu_api))
    return out


def parity_phase(dev):
    """Card vs CPU, one round each.  FedAvg and FedOpt's sgd channels are
    linear in the clients' results: cuDNN sums convolutions in another
    order than the CPU, and one SGD epoch at lr 0.05 keeps that under 1e-3.
    Adam divides the pseudo-gradient by its own RMS, so each parameter
    moves by about server_lr whatever its size, and a component below that
    training noise can flip sign: every element within 2·server_lr, and at
    least 99 % of them within 1e-5 (the ones that do not flip agree to
    float32 rounding)."""
    launches = {}
    for label, kw, channel, reduces in PARITY:
        reset_launches()
        gpu_vars, gpu_m, api = _small_round(dev, **kw)
        torch.cuda.synchronize()
        launches[label] = read_launches()
        cpu_vars, cpu_m, cpu_api = _small_round(torch.device("cpu"), **kw)
        groups = len(api.global_vars)
        if channel is None:
            check(launches[label]["weighted_reduce"] == reduces * groups
                  and launches[label]["fused_epilogue"] == 0,
                  f"{label}: launches {launches[label]}")
        else:
            check(launches[label]["fused_epilogue"] == 1
                  and launches[label][f"fused_epilogue.{channel}"] == 1
                  and launches[label]["weighted_reduce"] == groups,
                  f"{label}: launches {launches[label]}")
        states = _state_diffs(api, cpu_api)
        for name, (diff, bound) in states.items():
            check(diff <= bound, f"{label}: card vs CPU max |Δ{name}| "
                  f"{diff:.3g}, bound {bound:.3g}")
        d_stats = np.abs(_flat_tree(gpu_vars, "batch_stats")
                         - _flat_tree(cpu_vars, "batch_stats"))
        d_params = np.abs(_flat_tree(gpu_vars, "params")
                          - _flat_tree(cpu_vars, "params"))
        check(d_stats.max() <= 1e-3,
              f"{label}: card vs CPU max |Δbatch_stats| {d_stats.max():.3g}")
        if channel == "adam":
            lr = float(kw["server_lr"])
            close = float(np.mean(d_params <= 1e-5))
            check(d_params.max() <= 2 * lr and close >= 0.99,
                  f"{label}: card vs CPU max |Δparams| "
                  f"{d_params.max():.3g} (limit {2 * lr:g}), "
                  f"{close:.2%} within 1e-5")
            extra = f", {close:.3%} of params within 1e-5"
        else:
            check(d_params.max() <= 1e-3,
                  f"{label}: card vs CPU max |Δparams| {d_params.max():.3g}")
            extra = ""
        dl = abs(gpu_m["train_loss"] - cpu_m["train_loss"])
        check(dl <= 1e-4 * max(1.0, abs(cpu_m["train_loss"])),
              f"{label}: train_loss {gpu_m['train_loss']} vs "
              f"{cpu_m['train_loss']}")
        extra += "".join(f", max |Δ{name}| {diff:.2e} (bound {bound:.1e})"
                         for name, (diff, bound) in states.items())
        phase(5, "parity", f"ResNet-8 f32 round, {label}, card vs CPU: max "
              f"|Δparams| {d_params.max():.2e}, max |Δbatch_stats| "
              f"{d_stats.max():.2e}{extra}, train_loss "
              f"{gpu_m['train_loss']:.6f} vs {cpu_m['train_loss']:.6f}, "
              f"test_acc {gpu_m['test_acc']:.4f} vs {cpu_m['test_acc']:.4f}; "
              f"card launches "
              + ", ".join(f"{k} {v}" for k, v in launches[label].items()
                          if v))
    return launches


def _small_lm_round(device):
    """One uniform Parrot FedOpt round (server adam at 0.1, the config-3
    settings at 4 clients, batch 8) of the full-width ``TinyTransformerLM``
    at dropout 0 in float32 on ``device``, from the same seeded
    variables."""
    args = fedml_tpu_torch.Config(
        dataset="fed_shakespeare", backend="parrot", client_num_in_total=4,
        client_num_per_round=4, comm_round=1, batch_size=8,
        learning_rate=0.05, data_scale=0.05, compute_dtype="float32",
        frequency_of_the_test=1, federated_optimizer="FedOpt",
        server_optimizer="adam", server_lr=0.1,
        data_cache_dir=os.path.join(ROOT, ".data_cache", "chip_smoke_small"))
    dataset = fedml_tpu_torch.data.load(args)
    module = TinyTransformerLM(dropout=0.0,
                               generator=torch.Generator().manual_seed(0))
    api = ParrotAPI(args, device, dataset,
                    ModelBundle(module, (80,), 90, task=TASK_LM,
                                input_dtype=torch.int32))
    final = api.train()
    return api.global_flax_variables(), final, api


def lm_parity_phase(dev):
    """Card vs CPU, one FedOpt round of the transformer at dropout 0: its
    training runs the flash kernel forward and the blockwise backward on
    the card, the plain forward and the same backward on the CPU.  Adam is
    held as in ``parity_phase``: every parameter within 2·server_lr, and at
    least 99 % within 1e-5."""
    reset_launches()
    gpu_vars, gpu_m, api = _small_lm_round(dev)
    torch.cuda.synchronize()
    launches = read_launches()
    cpu_vars, cpu_m, _ = _small_lm_round(torch.device("cpu"))
    check(launches["flash_attention"] > 0
          and launches["fused_epilogue.adam"] == 1
          and launches["weighted_reduce"] == 0,
          f"transformer FedOpt round launched {launches}")
    d = np.abs(_flat_tree(gpu_vars, "params") - _flat_tree(cpu_vars,
                                                           "params"))
    close = float(np.mean(d <= 1e-5))
    check(d.max() <= 2 * 0.1 and close >= 0.99,
          f"transformer round: card vs CPU max |Δparams| {d.max():.3g}, "
          f"{close:.2%} within 1e-5")
    dl = abs(gpu_m["train_loss"] - cpu_m["train_loss"])
    check(dl <= 1e-4 * max(1.0, abs(cpu_m["train_loss"])),
          f"transformer round: train_loss {gpu_m['train_loss']} vs "
          f"{cpu_m['train_loss']}")
    phase(5, "parity", f"TinyTransformerLM f32 dropout 0 round, FedOpt "
          f"adam 0.1, card vs CPU: max |Δparams| {d.max():.2e}, "
          f"{close:.3%} of params within 1e-5, train_loss "
          f"{gpu_m['train_loss']:.6f} vs {cpu_m['train_loss']:.6f}, token "
          f"test_acc {gpu_m['test_acc']:.4f} vs {cpu_m['test_acc']:.4f}; "
          f"card launches "
          + ", ".join(f"{k} {v}" for k, v in launches.items() if v))
    return launches


def _cs_round(device):
    """One cross-silo FedAvg round over INPROC of a ResNet-8 in float32, 3
    silos, int8 wire codec, on ``device``, from the same seeded variables:
    the final global tree, the final metrics and the server."""
    args = fedml_tpu_torch.init(fedml_tpu_torch.Config(
        dataset="cifar10", training_type="cross_silo", backend="INPROC",
        role="simulated", client_num_in_total=3, client_num_per_round=3,
        comm_round=1, batch_size=16, learning_rate=0.05, data_scale=0.02,
        compute_dtype="float32", frequency_of_the_test=1,
        wire_compression="int8", run_id=f"smoke_cs8_{device.type}",
        device_type=device.type,
        data_cache_dir=os.path.join(ROOT, ".data_cache", "chip_smoke_small")))
    dataset = fedml_tpu_torch.data.load(args)
    module = CIFARResNet(depth=8, num_classes=10,
                         generator=torch.Generator().manual_seed(0))
    runner = FedMLRunner(args, device, dataset,
                         ModelBundle(module, (32, 32, 3), 10))
    final = runner.run()
    server = runner.runner.server
    return server.aggregator.get_global_model_params(), final, server


def cs_parity_phase(dev):
    """Card vs CPU, one int8-wire cross-silo round.  The broadcast is the
    same bits on both (the kernels match their plain versions bit for
    bit); training differs by cuDNN's summation order, under 1e-3 as in
    the Parrot rounds; and where that moves an upload's value across an
    int8 rounding boundary, its int8 value differs by one step, which
    moves the aggregate by up to one step of the largest upload scale.
    So: every variable within 1e-3 + that step, and at least 99 % within
    1e-4.  The card's launches must be the protocol's: N + 1 quantize,
    3N + 1 dequantize, 1 reduce."""
    reset_launches()
    gpu_tree, gpu_m, gpu_server = _cs_round(dev)
    torch.cuda.synchronize()
    launches = read_launches()
    cpu_tree, cpu_m, cpu_server = _cs_round(torch.device("cpu"))
    n = 3
    check(launches["wire_compression.quantize"] == n + 1
          and launches["wire_compression.dequantize"] == 3 * n + 1
          and launches["weighted_reduce"] == 1,
          f"cross-silo round launched {launches}")
    # each silo's decoded upload minus the round's reference is its
    # dequantized delta, whose largest value is 127 of its largest scale
    ref = tree_leaves(gpu_server._round_ref)
    step = max(float((u - r).abs().max()) for up in
               gpu_server.aggregator.model_dict.values()
               for u, r in zip(tree_leaves(up), ref)) / 127.0
    diffs = torch.cat([(g.cpu() - c).abs().reshape(-1) for g, c in
                       zip(tree_leaves(gpu_tree), tree_leaves(cpu_tree))])
    d = float(diffs.max())
    close = float((diffs <= 1e-4).float().mean())
    check(d <= 1e-3 + step and close >= 0.99,
          f"cross-silo round: card vs CPU max |Δ| {d:.3g} (limit 1e-3 + "
          f"one int8 step {step:.3g}), {close:.3%} within 1e-4")
    gl = gpu_server.round_history[0]["train_loss"]
    cl = cpu_server.round_history[0]["train_loss"]
    check(abs(gl - cl) <= 1e-4 * max(1.0, abs(cl)),
          f"cross-silo round: train_loss {gl} vs {cl}")
    phase(5, "parity", f"cross-silo ResNet-8 f32 round over INPROC, 3 silos, "
          f"int8 wire, card vs CPU: max |Δvariables| {d:.2e} (limit 1e-3 + "
          f"one int8 step {step:.2e}), {close:.3%} within 1e-4, "
          f"{float((diffs <= 1e-6).float().mean()):.3%} within 1e-6, mean "
          f"silo train_loss {gl:.6f} vs {cl:.6f}, test_acc "
          f"{gpu_m['test_acc']:.4f} vs {cpu_m['test_acc']:.4f}; card "
          f"launches " + ", ".join(f"{k} {v}" for k, v in launches.items()
                                   if v))
    return launches


def _fed_llm_round(device):
    """One fed-LLM round over INPROC — 2 silos, the full-width
    TinyTransformerLM at dropout 0 in float32 (so both devices draw no
    dropout), rank 4, seq 32, batch 4 — through the five steps on
    ``device``, from the same seeded variables and adapters: the final
    adapters, the metrics and the run id."""
    run_id = f"smoke_fed_llm_{device.type}"
    args = fedml_tpu_torch.init(fedml_tpu_torch.Config(**dict(
        FED_LLM_CONFIG, comm_round=1, data_scale=0.05, run_id=run_id,
        device_type=device.type,
        data_cache_dir=os.path.join(ROOT, ".data_cache",
                                    "chip_smoke_small"))))
    dataset = fedml_tpu_torch.data.load(args)
    bundle = ModelBundle(TinyTransformerLM(
        dropout=0.0, generator=torch.Generator().manual_seed(0)), (80,), 90,
        task=TASK_LM, input_dtype=torch.int32)
    runner = FedMLRunner(args, device, dataset, bundle)
    final = runner.run()
    return (runner.runner.server.aggregator.get_global_model_params(),
            final, run_id)


def fed_llm_parity_phase(dev):
    """Card vs CPU, one fed-LLM round.  The silos' adam moves every factor
    element by about lr per step whatever its gradient's size, so an
    element whose gradient is at the level of the devices' summation-order
    noise can move another way: every element within 2·lr·steps, at least
    99 % within 1e-4, the eval loss within rtol 1e-4.  The card round
    launches the fold and the weighted reduce once each, and the flash
    kernel once per layer of every forward pass (training at dropout 0 and
    eval)."""
    reset_launches()
    gpu, gpu_m, run_id = _fed_llm_round(dev)
    torch.cuda.synchronize()
    launches = read_launches()
    cpu, cpu_m, _ = _fed_llm_round(torch.device("cpu"))
    steps = int(sum(FED_LLM_TOKENS.for_run(run_id).values())) // (32 * 4)
    n_eval = -(-int(cpu_m["test_total"]) // (80 * 4))
    check(launches["fold_delta"] == 1 and launches["weighted_reduce"] == 1
          and launches["flash_attention"] == 2 * (steps + n_eval),
          f"fed-LLM round launched {launches}; want fold_delta 1, "
          f"weighted_reduce 1, flash_attention {2 * (steps + n_eval)}")
    diffs = torch.cat([(g.cpu() - c).abs().reshape(-1) for g, c in
                       zip(tree_leaves(gpu), tree_leaves(cpu))])
    d = float(diffs.max())
    close = float((diffs <= 1e-4).float().mean())
    limit = 2 * 3e-3 * steps
    check(d <= limit and close >= 0.99,
          f"fed-LLM round: card vs CPU max |Δadapters| {d:.3g} (limit "
          f"{limit:.3g}), {close:.3%} within 1e-4")
    dl = abs(gpu_m["test_loss"] - cpu_m["test_loss"])
    check(dl <= 1e-4 * abs(cpu_m["test_loss"]),
          f"fed-LLM round: test_loss {gpu_m['test_loss']} vs "
          f"{cpu_m['test_loss']}")
    phase(5, "parity", f"fed-LLM round over INPROC, 2 silos, transformer "
          f"f32 dropout 0, rank 4 ({steps} local steps in all), card vs "
          f"CPU: max |Δadapters| {d:.2e} (limit {limit:.3g}), {close:.3%} "
          f"within 1e-4, "
          f"{float((diffs <= 1e-6).float().mean()):.3%} within 1e-6, "
          f"test_loss {gpu_m['test_loss']:.6f} vs {cpu_m['test_loss']:.6f} "
          f"(tolerance rtol 1e-4); card launches "
          + ", ".join(f"{k} {v}" for k, v in launches.items() if v))
    return launches


def _drive(config, unit="samples", rounds=ROUNDS, dataset=None):
    """Run ``config`` through ``init → device → data → model →
    FedMLRunner(...).run()`` with the launch counts set to 0 just before
    and read just after; check the rounds, the globals and test_acc.
    ``dataset``: the data step's result of an earlier drive of the same
    data config, taken instead of loading it again."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    args = fedml_tpu_torch.init(fedml_tpu_torch.Config(**config))
    device = fedml_tpu_torch.device.get_device(args)
    if dataset is None:
        dataset = fedml_tpu_torch.data.load(args)
    t_data = time.perf_counter() - t0
    bundle = fedml_tpu_torch.model.create(args, dataset[-1])
    runner = FedMLRunner(args, device, dataset, bundle)
    api = runner.runner
    start = [f.clone() for f in _global_leaves(api)]
    final = runner.run()
    torch.cuda.synchronize()
    launches = read_launches()
    total = time.perf_counter() - t0

    hist = api.round_history
    check(len(hist) == rounds, f"{len(hist)} rounds ran, not {rounds}")
    for r in hist:
        print(f"    round {r['round']}: train_loss {r['train_loss']:.6f}, "
              f"{r['train_seconds']:.3f} s, {r['samples_trained']:.0f} "
              f"{unit} trained", flush=True)
        check(math.isfinite(r["train_loss"]),
              f"round {r['round']}: train_loss {r['train_loss']}")
    secs = sum(r["train_seconds"] for r in hist)
    steady = hist[1:]
    steady_secs = sum(r["train_seconds"] for r in steady)
    samples = sum(r["samples_trained"] for r in hist)
    moved = max(float((f - f0).abs().max())
                for f, f0 in zip(_global_leaves(api), start))
    check(moved > 0.0, "the global variables did not move")
    check(all(bool(torch.isfinite(f).all()) for f in _global_leaves(api)),
          "non-finite global variables")
    check(math.isfinite(final["test_acc"]) and 0 <= final["test_acc"] <= 1,
          f"test_acc {final['test_acc']}")
    return dict(args=args, api=api, final=final, launches=launches,
                secs=secs, steady=len(steady) / steady_secs, samples=samples,
                t_data=t_data, total=total, dataset=dataset,
                peak=torch.cuda.max_memory_allocated())


def _global_leaves(api):
    """The global model's tensors: the Parrot API's flat buffer per dtype,
    or the SP API's variables tree."""
    g = api.global_vars
    return tree_leaves(g) if "params" in g else list(g.values())


#: the per-round path's rounds/s after round 0, by main-path label
PER_ROUND_RATE = {}


def main_path_phase(n, label, **overrides):
    run = _drive(dict(MAIN_CONFIG, **overrides))
    api, launches, final = run["api"], run["launches"], run["final"]
    groups = len(api.global_vars)
    fedopt = api.algo == "FedOpt"
    want_fused = ROUNDS * len(api.vars.param_dtypes()) if fedopt else 0
    check(launches["weighted_reduce"] == ROUNDS * groups
          and launches["fused_epilogue"] == want_fused,
          f"{ROUNDS} rounds over {groups} dtype group(s) launched "
          f"{launches}")
    extra = ""
    if fedopt:
        check(launches["fused_epilogue.adam"] == want_fused,
              f"FedOpt's server adam ran {launches}")
        ts = [st["t"] for st in api.server_state["opt_state"].values()]
        check(ts == [ROUNDS] * len(ts), f"adam step counts {ts}")
        cols = api.vars.stats_range(torch.float32)
        extra = (f", adam t {ts}, server step = fused_epilogue over columns "
                 f"[0, {cols.start}) + weighted_reduce over "
                 f"[{cols.start}, {cols.stop})")
    args = run["args"]
    PER_ROUND_RATE[label] = run["steady"]
    phase(n, "main path", f"Parrot {label} {args.model} {args.compute_dtype}"
          f", {api.n_total} clients, {api.n_buckets} strata, {ROUNDS} rounds: "
          f"{ROUNDS / run['secs']:.3f} rounds/s over all rounds "
          f"({run['steady']:.3f} after round 0), "
          f"{run['samples'] / run['secs']:.1f} samples/s, final test_acc "
          f"{final['test_acc']:.4f} test_loss {final['test_loss']:.4f}, "
          f"peak memory {run['peak'] / 2**30:.2f} GiB, launches "
          + ", ".join(f"{k} {v}" for k, v in launches.items() if v)
          + f"{extra}, data {run['t_data']:.1f} s, whole phase "
          f"{run['total']:.1f} s")
    return launches, api, run["dataset"]


def lm_main_path_phase(n):
    """BASELINE config 3 at full width: every eval batch launches the flash
    kernel once per block, training (dropout 0.1) takes the plain attention,
    and each round's server step is one fused adam launch (no BatchNorm
    columns, so no weighted reduce)."""
    run = _drive(LM_CONFIG, unit="tokens")
    api, launches, final = run["api"], run["launches"], run["final"]
    n_test = int(api.test_num)
    evals = len(api.metrics_history)
    want_flash = 2 * (-(-n_test // api.bs)) * evals
    check(evals == ROUNDS and launches["flash_attention"] == want_flash
          and launches["fused_epilogue.adam"] == ROUNDS
          and launches["fused_epilogue"] == ROUNDS
          and launches["weighted_reduce"] == 0,
          f"{ROUNDS} rounds with {evals} evals of {n_test} sequences "
          f"launched {launches}; want flash_attention {want_flash}")
    ts = [st["t"] for st in api.server_state["opt_state"].values()]
    check(ts == [ROUNDS], f"adam step counts {ts}")
    evals_s = [m["round_time"] - r["train_seconds"]
               for m, r in zip(api.metrics_history, api.round_history)]
    args = run["args"]
    PER_ROUND_RATE["config 3"] = run["steady"]
    phase(n, "main path", f"Parrot FedOpt (server adam {args.server_lr}) "
          f"{args.model} {args.compute_dtype} on {args.dataset}, "
          f"{api.n_total} clients, {api.k} per round, {api.train_num} train /"
          f" {n_test} test sequences of 80, {ROUNDS} rounds: "
          f"{ROUNDS / run['secs']:.3f} rounds/s over all rounds "
          f"({run['steady']:.3f} after round 0), "
          f"{run['samples'] / run['secs']:.1f} train tokens/s, eval "
          f"{statistics.median(evals_s):.3f} s per round, final token "
          f"test_acc {final['test_acc']:.4f} test_loss "
          f"{final['test_loss']:.4f}, peak memory "
          f"{run['peak'] / 2**30:.2f} GiB, launches flash_attention "
          f"{launches['flash_attention']} (2 per eval batch), "
          f"fused_epilogue.adam {launches['fused_epilogue.adam']}, "
          f"weighted_reduce {launches['weighted_reduce']}, data "
          f"{run['t_data']:.1f} s, whole phase {run['total']:.1f} s")
    return launches, api, run["dataset"]


def cross_silo_phase(n, codec_round_s):
    """The cross-silo main path with the int8 wire and raw, in turns (int8,
    raw, raw, int8: the two compare inside one call), each run through
    ``init → device → data → model → FedMLRunner(...).run()`` with the
    launch counts set to 0 just before and read just after.  Per round the
    protocol implies, with N silos: quantize N + 1 (the server's broadcast
    encode, cached for the round, and N uploads), dequantize 3N + 1 (the
    server's decode of its own broadcast, N silo decodes, N error-feedback
    residuals, N decodes of uploads), one weighted reduce.  The summary
    sets the int8 runs' extra seconds per round beside ``codec_round_s``,
    the codec's single-thread time for one round (phase 4)."""
    runs = []
    for turn, (codec, wire) in enumerate((("int8", "int8"), ("raw", None),
                                          ("raw", None), ("int8", "int8"))):
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        run_id = f"smoke_cs_{codec}_{turn}"
        t0 = time.perf_counter()
        args = fedml_tpu_torch.init(fedml_tpu_torch.Config(
            **CS_CONFIG, run_id=run_id, wire_compression=wire))
        device = fedml_tpu_torch.device.get_device(args)
        dataset = fedml_tpu_torch.data.load(args)
        t_data = time.perf_counter() - t0
        bundle = fedml_tpu_torch.model.create(args, dataset[-1])
        runner = FedMLRunner(args, device, dataset, bundle)
        final = runner.run()
        torch.cuda.synchronize()
        launches = read_launches()
        total = time.perf_counter() - t0
        server = runner.runner.server
        hist, evals = server.round_history, server.aggregator.metrics_history
        check(len(hist) == ROUNDS and len(evals) == ROUNDS,
              f"{codec}: {len(hist)} rounds and {len(evals)} evals, not "
              f"{ROUNDS}")
        for h, m in zip(hist, evals):
            print(f"    {codec} run {turn} round {h['round']}: mean silo "
                  f"train_loss {h['train_loss']:.6f}, {h['seconds']:.3f} s, "
                  f"{h['samples']:.0f} samples; test_loss "
                  f"{m['test_loss']:.4f} test_acc {m['test_acc']:.4f}",
                  flush=True)
            check(math.isfinite(h["train_loss"])
                  and math.isfinite(m["test_loss"])
                  and 0 <= m["test_acc"] <= 1,
                  f"{codec} round {h['round']}: {h}, {m}")
        check(all(bool(torch.isfinite(t).all()) for t in tree_leaves(
            server.aggregator.get_global_model_params())),
            f"{codec}: non-finite global variables")
        want_q = ROUNDS * (SILOS + 1) if wire else 0
        want_d = ROUNDS * (3 * SILOS + 1) if wire else 0
        # the broadcast's 287 leaves by value, each upload and residual flat
        want_bv = ROUNDS if wire else 0
        check(launches["wire_compression.quantize"] == want_q
              and launches["wire_compression.dequantize"] == want_d
              and launches["quantize_form.by_value"] == want_bv
              and launches["quantize_form.flat"] == want_q - want_bv
              and launches["dequantize_form.table"] == 0
              and launches["weighted_reduce"] == ROUNDS
              and launches["fused_epilogue"] == 0,
              f"{codec}: {ROUNDS} rounds of {SILOS} silos launched "
              f"{launches}; want quantize {want_q}, dequantize {want_d}, "
              f"weighted_reduce {ROUNDS}")
        secs = sum(h["seconds"] for h in hist)
        steady = sum(h["seconds"] for h in hist[1:])
        samples = sum(h["samples"] for h in hist)
        nbytes = WIRE_BYTES.for_run(run_id)
        runs.append(dict(codec=codec, launches=launches, bytes=nbytes,
                         final=final, rounds_s=ROUNDS / secs,
                         round_s=secs / ROUNDS))
        phase(n, "main path", f"cross-silo FedAvg over INPROC, "
              f"{args.model} {args.compute_dtype}, {SILOS} silos, wire "
              f"{codec} (run {turn}), {ROUNDS} rounds: "
              f"{ROUNDS / secs:.3f} rounds/s ({(ROUNDS - 1) / steady:.3f} "
              f"after round 0), {samples / secs:.1f} samples/s, final "
              f"test_acc {final['test_acc']:.4f} test_loss "
              f"{final['test_loss']:.4f}, wire bytes "
              + ", ".join(f"{d} {c} {v}" for (d, c), v in
                          sorted(nbytes.items()))
              + f", peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
              f"launches quantize {launches['wire_compression.quantize']} "
              f"(flat {launches['quantize_form.flat']}, by value "
              f"{launches['quantize_form.by_value']}), "
              f"dequantize {launches['wire_compression.dequantize']} (flat "
              f"{launches['dequantize_form.flat']}, by value "
              f"{launches['dequantize_form.by_value']}), "
              f"weighted_reduce {launches['weighted_reduce']}, data "
              f"{t_data:.1f} s, whole run {total:.1f} s")
        runner = bundle = server = None
    raw, q8 = runs[1]["bytes"], runs[0]["bytes"]
    up = raw[("up", "raw")] / q8[("up", "int8")]
    down = raw[("down", "raw")] / q8[("down", "int8")]
    check(up > 3.0, f"int8 uplink only {up:.2f}x smaller than raw")
    rate = {c: statistics.mean(r["rounds_s"] for r in runs
                               if r["codec"] == c) for c in ("int8", "raw")}
    extra = (statistics.mean(r["round_s"] for r in runs if r["codec"] ==
                             "int8")
             - statistics.mean(r["round_s"] for r in runs if r["codec"] ==
                               "raw"))
    phase(n, "main path", f"raw / int8 wire bytes: uplink {up:.3f}x, "
          f"downlink {down:.3f}x; rounds/s int8 {rate['int8']:.3f} vs raw "
          f"{rate['raw']:.3f} (mean of two runs each): int8 takes "
          f"{extra:+.3f} s per round, the codec's single-thread work "
          f"{codec_round_s:.3f} s; test_acc int8 "
          f"{runs[0]['final']['test_acc']:.4f} vs raw "
          f"{runs[1]['final']['test_acc']:.4f}")
    return runs[0]["launches"]


def fed_llm_phase(n):
    """The fed-LLM main path, raw then with the int8 wire (the two compare
    inside one call), each through ``init → device → data → model →
    FedMLRunner(...).run()`` with the launch counts set to 0 just before
    and read just after.  Per round the protocol implies, with N silos: one
    fold, in the flat-range form (the adapters, the delta and the result
    each one buffer in flatten order: the kernel reads no segment table),
    and one weighted reduce (the deltas' ``[N, 11,112]`` stack), the
    flash kernel once per layer of every eval batch (training at dropout
    0.1 takes the plain attention), and on the int8 wire N + 1 quantize and
    3N + 1 dequantize.  The eval's seconds are the server's
    ``FedLLMAggregator.test`` calls, timed by a wrapper for this phase
    only.  Checks: the server's eval loss finite, its last value below the
    first and below ln 90 (a uniform guess over the vocabulary), and the
    raw uplink at least 20x smaller than the full model's variables."""
    runs = []
    eval_s = []
    plain_test = FedLLMAggregator.test

    def timed_test(self, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = plain_test(self, *a, **kw)
        eval_s.append(time.perf_counter() - t0)
        return out

    last = None
    for turn, (codec, wire) in enumerate((("raw", None), ("int8", "int8"))):
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        eval_s.clear()
        reset_launches()
        run_id = f"smoke_fed_llm_{codec}_{turn}"
        t0 = time.perf_counter()
        args = fedml_tpu_torch.init(fedml_tpu_torch.Config(
            **FED_LLM_CONFIG, run_id=run_id, wire_compression=wire))
        device = fedml_tpu_torch.device.get_device(args)
        dataset = fedml_tpu_torch.data.load(args)
        t_data = time.perf_counter() - t0
        bundle = fedml_tpu_torch.model.create(args, dataset[-1])
        runner = FedMLRunner(args, device, dataset, bundle)
        FedLLMAggregator.test = timed_test
        try:
            final = runner.run()
        finally:
            FedLLMAggregator.test = plain_test
        torch.cuda.synchronize()
        launches = read_launches()
        total = time.perf_counter() - t0
        server = runner.runner.server
        hist = server.round_history
        loss = final["server_loss_history"]
        check(len(hist) == ROUNDS and len(loss) == ROUNDS,
              f"{codec}: {len(hist)} rounds and {len(loss)} evals")
        for h, l_ in zip(hist, loss):
            print(f"    fed-LLM {codec} round {h['round']}: mean silo "
                  f"train_loss {h['train_loss']:.6f}, {h['seconds']:.3f} s, "
                  f"{h['samples']:.0f} sequences; server eval loss "
                  f"{l_:.4f}", flush=True)
        check(all(math.isfinite(x) for x in loss) and loss[-1] < loss[0]
              and loss[-1] < math.log(90),
              f"{codec}: server eval loss {loss} must be finite and fall "
              f"below its start and below ln 90 = {math.log(90):.4f}")
        check(all(bool(torch.isfinite(t).all()) for t in tree_leaves(
            server.aggregator.get_global_model_params())),
            f"{codec}: non-finite global adapters")
        n_eval = -(-len(dataset[3][1]) // int(args.batch_size))
        want = {"fold_delta": ROUNDS, "fold_delta.flat": ROUNDS,
                "weighted_reduce": ROUNDS,
                "flash_attention": 2 * n_eval * ROUNDS,
                "wire_compression.quantize":
                    ROUNDS * (LLM_SILOS + 1) if wire else 0,
                "wire_compression.dequantize":
                    ROUNDS * (3 * LLM_SILOS + 1) if wire else 0,
                "fused_epilogue": 0}
        got = {k: launches[k] for k in want}
        check(got == want, f"{codec}: {ROUNDS} rounds of {LLM_SILOS} silos "
              f"launched {got}; the protocol implies {want}")
        secs = sum(h["seconds"] for h in hist)
        tokens = FED_LLM_TOKENS.for_run(run_id)
        tok_s = {silo: tokens[silo] / FED_LLM_TRAIN_SECONDS.value(run_id,
                                                                  silo)
                 for silo in sorted(tokens)}
        nbytes = WIRE_BYTES.for_run(run_id)
        full = estimate_nbytes(tree_from_module(bundle.module))
        up_codec = codec if wire else "raw"
        per_upload = nbytes[("up", up_codec)] / (LLM_SILOS * ROUNDS)
        reduction = full / per_upload
        if not wire:
            check(reduction >= 20.0, f"raw uplink only {reduction:.1f}x "
                  f"smaller than the full model's {full} bytes")
        runs.append(dict(codec=codec, launches=launches, bytes=nbytes,
                         rounds_s=ROUNDS / secs, reduction=reduction))
        phase(n, "main path", f"fed-LLM LoRA SFT over INPROC, "
              f"{args.model} {args.compute_dtype} on {args.dataset}, "
              f"{LLM_SILOS} silos, rank {args.lora_rank}, "
              f"{final['adapter_params']} adapter params, wire {codec}, "
              f"{ROUNDS} rounds (cut: 3 rounds at the JAX package's "
              f"--federated --quick size, data_scale 0.5): "
              f"{ROUNDS / secs:.3f} rounds/s "
              f"({(ROUNDS - 1) / sum(h['seconds'] for h in hist[1:]):.3f} "
              f"after round 0), train tokens/s per silo "
              + ", ".join(f"{k} {v:.0f}" for k, v in tok_s.items())
              + f", eval {statistics.median(eval_s):.3f} s per round "
              f"({n_eval} batches), server eval loss "
              + " -> ".join(f"{x:.4f}" for x in loss)
              + f", test_acc {final['test_acc']:.4f}, peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, wire "
              f"bytes " + ", ".join(f"{d} {c} {v}" for (d, c), v in
                                    sorted(nbytes.items()))
              + f", uplink {reduction:.1f}x smaller than the full model's "
              f"{full} bytes, launches "
              + ", ".join(f"{k} {v}" for k, v in got.items() if v)
              + f" (as the protocol implies), data {t_data:.1f} s, whole "
              f"run {total:.1f} s")
        last = (args, dataset, bundle)
        runner = server = None
    phase(n, "main path", f"fed-LLM raw / int8: rounds/s "
          f"{runs[0]['rounds_s']:.3f} / {runs[1]['rounds_s']:.3f}, uplink "
          f"reduction {runs[0]['reduction']:.1f}x / "
          f"{runs[1]['reduction']:.1f}x against the full model, raw / int8 "
          f"uplink bytes "
          f"{runs[0]['bytes'][('up', 'raw')] / runs[1]['bytes'][('up', 'int8')]:.3f}x")
    return runs[0]["launches"], last


def trace_fed_llm(last):
    """One silo's local epoch of the fed-LLM path (cut to the silo's first
    64 sequences, so that the trace stays small): LoRA merge, forward,
    backward, clip and adamw per step, under ``torch.profiler``."""
    args, dataset, bundle = last
    device = fedml_tpu_torch.device.get_device(args)
    trainer = FedLLMTrainer(bundle, args, device)
    trainer.set_id(0)
    x = np.asarray(dataset[5][0][0])[:64]
    steps = ((x.size - 1) // 32) // 4
    trace_phase(13, f"one silo's local epoch of the fed-LLM path (its first "
                f"64 sequences, {steps} steps)",
                lambda: trainer.train((x, x)), steps, batch=4)


def trace_phase(n, what, one_client_round, nb, batch=32):
    """``one_client_round`` — one client trained and aggregated by a main
    path's round code — timed once plainly and once under
    ``torch.profiler`` (same seed, same work): the device's busy time from
    the profiler's kernel records against the plain wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def run():
        one_client_round()
        torch.cuda.synchronize()

    run()                                   # warm
    t0 = time.perf_counter()
    run()
    wall = time.perf_counter() - t0
    time.sleep(TRACE_PAD_S)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(TRACE_PAD_S)
        run()
        time.sleep(TRACE_PAD_S)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        phase(n, "trace", "the profiler recorded no device activity: "
              "device busy time not measured")
        return
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e6
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0) + e.time_range.elapsed_us()
    server = sum(us for name, us in by_name.items()
                 if "fused_epilogue" in name or "weighted_reduce" in name)
    flash = sum(us for name, us in by_name.items() if "flash_fwd" in name)
    phase(n, "trace", f"{what} ({nb} batches of {batch}): wall {wall:.3f} s, "
          f"device busy {busy:.3f} s ({busy / wall:.1%}; idle "
          f"{1 - busy / wall:.1%}), {len(kernels)} device activities "
          f"({len(kernels) / nb:.0f} per batch), server step (fused_epilogue"
          f" + weighted_reduce) {server / 1e3:.4f} ms, flash_attention "
          f"{flash / 1e3:.4f} ms")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        print(f"    {us / 1e3:9.2f} ms  {name[:100]}", flush=True)


def trace_resnet(api):
    """One client of the middle size stratum of the FedOpt ResNet path."""
    buckets = api.buckets
    mid = buckets[len(buckets) // 2]
    api.buckets = [mid]
    try:
        trace_phase(8, "one client of the middle stratum, trained and "
                    "aggregated with FedOpt",
                    lambda: float(api._bucketed_round_step(
                        torch.Generator().manual_seed(99))["train_loss"]),
                    mid["nb"])
    finally:
        api.buckets = buckets


def trace_lm(api):
    """One client of median size of the BERT-tiny path, trained (dropout
    0.1, the plain attention) and aggregated with server adam."""
    sizes = api.local_num_dict
    cid = sorted(sizes, key=lambda c: sizes[c])[len(sizes) // 2]
    trace_phase(10, f"one client of the BERT-tiny path ({sizes[cid]} "
                "sequences), trained and aggregated with FedOpt",
                lambda: float(api._round_step(
                    np.array([cid]))["train_loss"]),
                -(-sizes[cid] // api.bs))


# ------------------------------------------------ the multi-client conv
#: (name, H, Ci, Co, k, stride, count in one pass): ResNet-56's eight
#: distinct convolutions, square inputs, channels-last per client
RESNET56_CONVS = [
    ("32x32 3->16 3x3 s1", 32, 3, 16, 3, 1, 1),
    ("32x32 16->16 3x3 s1", 32, 16, 16, 3, 1, 18),
    ("32x32 16->32 3x3 s2", 32, 16, 32, 3, 2, 1),
    ("32x32 16->32 1x1 s2", 32, 16, 32, 1, 2, 1),
    ("16x16 32->32 3x3 s1", 16, 32, 32, 3, 1, 17),
    ("16x16 32->64 3x3 s2", 16, 32, 64, 3, 2, 1),
    ("16x16 32->64 1x1 s2", 16, 32, 64, 1, 2, 1),
    ("8x8 64->64 3x3 s1", 8, 64, 64, 3, 1, 17),
]
#: the shape that takes 18 of the 57 convs, and the kernels' JSON rows
MC_MAIN = "32x32 16->16 3x3 s1"
MC_K, MC_B = 10, 32
#: tests/test_mc_conv.py:19-25, (K, B, H, W, Ci, Co, kh, kw, stride)
MC_UNIT_CASES = [
    (3, 4, 8, 8, 16, 16, 3, 3, (1, 1)),
    (2, 4, 8, 8, 16, 32, 3, 3, (2, 2)),
    (2, 4, 8, 8, 16, 32, 1, 1, (2, 2)),
    (2, 2, 5, 7, 8, 8, 3, 3, (1, 1)),
    (2, 2, 6, 6, 8, 8, 2, 2, (1, 1)),
]


def _mc_shape_case(h, ci, co, k, s):
    return (MC_K, MC_B, h, h, ci, co, k, k, (s, s))


def _mc_tensors(case, dtype, gen, dev):
    """x, per-client weights at the lecun scale, and a cotangent g."""
    k, b, h, w_, ci, co, kh, kw, stride = case
    oh, ow = -(-h // stride[0]), -(-w_ // stride[1])
    x = torch.randn(k, b, h, w_, ci, generator=gen)
    w = torch.randn(k, kh, kw, ci, co, generator=gen) * (kh * kw * ci) ** -0.5
    g = torch.randn(k, b, oh, ow, co, generator=gen)
    return tuple(t.to(dtype).to(dev) for t in (x, w, g))


def _sum_err(got, ref, abs_terms, n, label):
    """Max |got − ref| for sums of ``n`` float32 products taken in another
    order: checked against √n · 2^-23 · Σ|terms| (``abs_terms``, the same
    sums over |operands|), plus one bfloat16 step of ``ref`` (2^-7·|ref|)
    where the output is bfloat16."""
    check(got.dtype == ref.dtype and got.shape == ref.shape,
          f"{label}: kernel gave {got.dtype} {tuple(got.shape)}, plain "
          f"version {ref.dtype} {tuple(ref.shape)}")
    g, r = got.float(), ref.float()
    check(bool(torch.isfinite(g).all()), f"{label}: non-finite kernel output")
    diff = (g - r).abs()
    tol = math.sqrt(n) * 2.0 ** -23 * abs_terms.float()
    if got.dtype == torch.bfloat16:
        tol = tol + 2.0 ** -7 * r.abs()
    check(bool((diff <= tol).all()),
          f"{label}: kernel vs plain max |err| {float(diff.max()):.3g} past "
          f"√{n}·2^-23·Σ|terms| (+ one bfloat16 step)")
    return float(diff.max())


def mc_kernel_phase(dev):
    """Kernels B13 and B14 against their plain versions on the card: the
    forward, dx through the forward kernel (stride-1 odd convs: the
    forward on g with flipped, transposed weights) and dw, at
    tests/test_mc_conv.py's five cases and ResNet-56's eight shapes at
    10 clients of batch 32, in float32 and bfloat16."""
    gen = torch.Generator().manual_seed(11)
    cases = [(f"unit {c[:9]}", c) for c in MC_UNIT_CASES] + [
        (name, _mc_shape_case(h, ci, co, k, s))
        for name, h, ci, co, k, s, _ in RESNET56_CONVS]
    errs = {"mc_conv.fwd": 0.0, "mc_conv.wgrad": 0.0}
    worst = {}
    n_dx = 0
    for dtype in (torch.float32, torch.bfloat16):
        for label, case in cases:
            x, w, g = _mc_tensors(case, dtype, gen, dev)
            _, kh, kw, ci, co = w.shape
            stride = case[8]
            tag = f"{label} {str(dtype)[6:]}"
            y = mcc.mc_conv_fwd(x, w, stride)
            dw = mcc.mc_conv_wgrad(x, g, kh, kw, stride)
            torch.cuda.synchronize()
            e_f = _sum_err(y, mcc.mc_conv_fwd_reference(x, w, stride),
                           mcc.mc_conv_fwd_reference(x.abs(), w.abs(),
                                                     stride),
                           kh * kw * ci, f"mc_conv.fwd {tag}")
            m = g.numel() // (g.shape[0] * co)
            e_w = _sum_err(dw, mcc.mc_conv_wgrad_reference(x, g, kh, kw,
                                                           stride),
                           mcc.mc_conv_wgrad_reference(x.abs(), g.abs(), kh,
                                                       kw, stride),
                           m, f"mc_conv.wgrad {tag}")
            e_d = 0.0
            if stride == (1, 1) and kh % 2 == 1 and kw % 2 == 1:
                w_flip = w.flip(1, 2).transpose(3, 4).contiguous()
                dx = mcc.mc_conv_fwd(g, w_flip, (1, 1))
                torch.cuda.synchronize()
                e_d = _sum_err(dx, mcc.mc_conv_fwd_reference(g, w_flip),
                               mcc.mc_conv_fwd_reference(g.abs(),
                                                         w_flip.abs()),
                               kh * kw * co, f"mc_conv dx {tag}")
                n_dx += 1
            errs["mc_conv.fwd"] = max(errs["mc_conv.fwd"], e_f, e_d)
            errs["mc_conv.wgrad"] = max(errs["mc_conv.wgrad"], e_w)
            worst[tag] = (e_f, e_d, e_w)
    top = sorted(worst.items(), key=lambda kv: -max(kv[1]))[:4]
    phase(3, "kernels", f"mc_conv forward, dx (forward kernel, {n_dx} "
          f"stride-1 odd cases) and wgrad vs plain versions over "
          f"{len(worst)} cases (the 5 unit cases and ResNet-56's 8 shapes at "
          f"K {MC_K}, B {MC_B}; f32 and bf16): max |err| fwd/dx "
          f"{errs['mc_conv.fwd']:.3g}, wgrad (f32 out) "
          f"{errs['mc_conv.wgrad']:.3g}; tolerance √terms·2^-23·Σ|terms| "
          f"(+ one bf16 step for bf16 outputs); largest (fwd, dx, dw): "
          + "; ".join(f"{k} {v[0]:.2g}/{v[1]:.2g}/{v[2]:.2g}"
                      for k, v in top))
    return errs


def _touched(n, k, s, pad_lo, out):
    """How many of n input rows a k-tap, stride-s conv reads."""
    return len({o * s + d - pad_lo for o in range(out) for d in range(k)
                if 0 <= o * s + d - pad_lo < n})


def mc_work(h, ci, co, k, s, kind, itemsize=2):
    """(bytes, FLOPs) the card must move and do for one conv of K = 10
    clients, batch 32: ``kind`` "fwd" (x read, w read, y written), "dx"
    (g and w read, dx written) or "wgrad" (x and g read, dw written in
    float32).  x counts only the pixels the conv reads (a 1x1 stride-2
    conv reads a quarter of them)."""
    oh, _, (pt, _), _ = mcc.same_padding(h, h, k, k, (s, s))
    used = _touched(h, k, s, pt, oh) ** 2
    x_b = MC_K * MC_B * used * ci * itemsize
    y_b = MC_K * MC_B * oh * oh * co * itemsize
    w_b = MC_K * k * k * ci * co * itemsize
    flops = 2 * MC_K * MC_B * oh * oh * k * k * ci * co
    if kind == "fwd":
        return x_b + w_b + y_b, flops
    if kind == "dx":
        return y_b + w_b + MC_K * MC_B * h * h * ci * itemsize, flops
    return x_b + y_b + MC_K * k * k * ci * co * 4, flops


def _grouped_layout(x, w, g, stride):
    """The grouped library call's operands, laid out and padded outside
    any timed call: x [B, K·Ci, Hp, Wp] and g [B, K·Co, OH, OW] channels
    last, w [K·Co, Ci, kh, kw]."""
    k, b, h, wd, ci = x.shape
    _, kh, kw, _, co = w.shape
    _, _, (pt, pb), (pl, pr) = mcc.same_padding(h, wd, kh, kw, stride)
    xg = F.pad(x.permute(1, 0, 4, 2, 3).reshape(b, k * ci, h, wd),
               (pl, pr, pt, pb)).contiguous(memory_format=torch.channels_last)
    gg = g.permute(1, 0, 4, 2, 3).reshape(b, k * co, *g.shape[2:4]
                                          ).contiguous(
        memory_format=torch.channels_last)
    wg = w.permute(0, 4, 3, 1, 2).reshape(k * co, ci, kh, kw).contiguous(
        memory_format=torch.channels_last)
    return xg, wg, gg


def mc_timing_phase(dev, card):
    """Kernels B13 and B14 at ResNet-56's eight shapes, bfloat16, K 10,
    B 32, cold L2, median of 50, a GPU sleep ahead of each call: the
    kernel twice, its plain version twice and one grouped library call
    (``F.conv2d(groups=K)`` or ``torch.nn.grad.conv2d_weight(groups=K)``,
    what the library arm ``impl="library"`` calls) on operands laid out
    and padded outside the timed call."""
    gen = torch.Generator().manual_seed(12)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    rows, table = {}, []
    for name, h, ci, co, k, s, count in RESNET56_CONVS:
        stride = (s, s)
        x, w, g = _mc_tensors(_mc_shape_case(h, ci, co, k, s),
                              torch.bfloat16, gen, dev)
        xg, wg, gg = _grouped_layout(x, w, g, stride)
        fns = {
            "fwd": dict(
                kernel=lambda: mcc.mc_conv_fwd(x, w, stride),
                plain=lambda: mcc.mc_conv_fwd_reference(x, w, stride),
                grouped=lambda: F.conv2d(xg, wg, stride=stride,
                                         groups=MC_K)),
            "wgrad": dict(
                kernel=lambda: mcc.mc_conv_wgrad(x, g, k, k, stride),
                plain=lambda: mcc.mc_conv_wgrad_reference(x, g, k, k,
                                                          stride),
                grouped=lambda: torch.nn.grad.conv2d_weight(
                    xg, wg.shape, gg, stride=stride, groups=MC_K)),
        }
        for kind, fn in fns.items():
            p1 = _time_ms(fn["plain"], flush, hide=True)
            k1 = _time_ms(fn["kernel"], flush, hide=True)
            lib = _time_ms(fn["grouped"], flush, hide=True)
            k2 = _time_ms(fn["kernel"], flush, hide=True)
            p2 = _time_ms(fn["plain"], flush, hide=True)
            nbytes, flops = mc_work(h, ci, co, k, s, kind)
            bound_ms, bound_by = _bound(nbytes, flops, card, peak="bf16")
            ms = statistics.median([k1, k2])
            row = dict(ms=ms, plain_ms=statistics.median([p1, p2]),
                       library_ms=lib, bound_ms=bound_ms,
                       bound_by=bound_by)
            rows[(name, kind)] = row
            table.append((name, kind, count, row))
            phase(4, "timing", f"mc_conv.{kind} at {name}, K {MC_K}, B "
                  f"{MC_B}, bf16, cold L2, median of 50: kernel {k1:.4f} / "
                  f"{k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms, grouped "
                  f"library call {lib:.4f} ms, bound {bound_ms:.5f} ms "
                  f"({bound_by}: {nbytes / 1e6:.2f} MB, "
                  f"{flops / 1e9:.3f} GFLOP at "
                  f"{card_peaks(card)[2] / 1e12:.0f} TFLOP/s dense bf16) -> "
                  f"{bound_ms / ms:.1%} of the bound; kernel / grouped "
                  f"{ms / lib:.2f}x")
    for kind in ("fwd", "wgrad"):
        tot = {key: sum(r[key] * c for n, kd, c, r in table if kd == kind)
               for key in ("ms", "library_ms", "bound_ms")}
        phase(4, "timing", f"mc_conv.{kind} summed over one pass's 57 convs "
              f"(each shape's median times its count): kernel "
              f"{tot['ms']:.3f} ms, grouped library {tot['library_ms']:.3f} "
              f"ms, bound {tot['bound_ms']:.4f} ms")
    return {f"mc_conv.{kind}": rows[(MC_MAIN, kind)]
            for kind in ("fwd", "wgrad")}


def resnet56_plan():
    """ResNet-56's convolutions in network order as (H, Ci, Co, k, s), and
    its blocks as (Conv_0, Conv_1, shortcut or None) indices into them."""
    convs, blocks = [(32, 3, 16, 3, 1)], []
    h, c = 32, 16
    for stage, f in enumerate((16, 32, 64)):
        for i in range(9):
            s = 2 if stage > 0 and i == 0 else 1
            c0 = len(convs)
            convs += [(h, c, f, 3, s), (-(-h // s), f, f, 3, 1)]
            short = None
            if s != 1 or c != f:
                short = len(convs)
                convs.append((h, c, f, 1, s))
            blocks.append((c0, c0 + 1, short))
            h, c = -(-h // s), f
    return convs, blocks


def resnet56_pass(x, ws, conv, convs, blocks, probe):
    """ResNet-56's convolutions with its ReLUs and residual adds (no
    BatchNorm), forward and backward: the dw of every conv."""
    y = torch.relu(conv(x, ws[0], convs[0][4]))
    for c0, c1, short in blocks:
        y0 = torch.relu(conv(y, ws[c0], convs[c0][4]))
        y1 = conv(y0, ws[c1], 1)
        r = y if short is None else conv(y, ws[short], convs[short][4])
        y = torch.relu(y1 + r)
    loss = (y.float() * probe).sum()
    return y, torch.autograd.grad(loss, ws)


def _time_pass(fn, reps=10):
    """Median (device ms, host wall ms) of ``fn`` over ``reps`` calls after
    two warm-up calls: CUDA events around each call, then a synchronize."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    dev_ms, wall_ms = [], []
    for _ in range(reps):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        wall_ms.append((time.perf_counter() - t0) * 1e3)
        dev_ms.append(s.elapsed_time(e))
    return statistics.median(dev_ms), statistics.median(wall_ms)


def _busy_ms(fn):
    """The device's busy time in one call of ``fn`` (after a warm call):
    the summed durations of the kernels ``torch.profiler`` records, and
    the share of it spent in this repo's mc_conv kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    time.sleep(TRACE_PAD_S)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(TRACE_PAD_S)
        fn()
        torch.cuda.synchronize()
        time.sleep(TRACE_PAD_S)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    check(kernels, "the profiler recorded no device activity")
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    ours = sum(e.time_range.elapsed_us() for e in kernels
               if "mma_kernel" in e.name or "fwd_kernel" in e.name
               or "wgrad_kernel" in e.name or "sum_splits" in e.name) / 1e3
    return busy, ours


def _rel(a, b):
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).norm() / b.norm())


def _f64_conv(x, w, s):
    """The float64 oracle of ``conv_for_clients``: each client's SAME conv
    through ``F.conv2d``, padded with ``F.pad`` first."""
    outs = []
    for xk, wk in zip(x, w):
        k = wk.shape[0]
        _, _, (pt, pb), (pl, pr) = mcc.same_padding(
            xk.shape[1], xk.shape[2], k, k, (s, s))
        xp = F.pad(xk.permute(0, 3, 1, 2), (pl, pr, pt, pb))
        outs.append(F.conv2d(xp, wk.permute(3, 2, 0, 1), stride=s)
                    .permute(0, 2, 3, 1))
    return torch.stack(outs)


def _cat(ts):
    return torch.cat([t.detach().float().reshape(-1) for t in ts])


def mc_main_path_phase(n, card, dev):
    """ResNet-56's 57 convolutions in network order, K 10 clients with
    per-client weights, batch 32, bfloat16, forward and backward through
    ``conv_for_clients`` (the kernels), the stem's input not requiring a
    gradient; launch counts set to 0 before and read after; the pass
    held to the same pass in float64 (cuDNN, one client at a time): in
    float32 and in bfloat16, no farther from it than the library arm's
    (``impl="library"``: one grouped ``F.conv2d`` a conv) pass; then the
    pass's device time (the events' span, idle gaps included, and the
    profiler's busy time) against the library arm and the summed
    bound."""
    convs, blocks = resnet56_plan()
    check(len(convs) == 57 and sum(c[3] == 3 and c[4] == 1 for c in convs)
          == 53, f"ResNet-56 plan: {len(convs)} convs")
    gen = torch.Generator().manual_seed(14)
    x32 = torch.randn(MC_K, MC_B, 32, 32, 3, generator=gen).to(dev)
    w32 = [(torch.randn(MC_K, k, k, ci, co, generator=gen)
            * (k * k * ci) ** -0.5).to(dev) for _, ci, co, k, _ in convs]
    probe = torch.randn(MC_K, MC_B, 8, 8, 64, generator=gen).to(dev)

    def kernel_conv(a, w, s):
        return mcc.conv_for_clients(a, w, (s, s))

    def library_conv(a, w, s):
        return mcc.conv_for_clients(a, w, (s, s), impl="library")

    def run(conv, dtype):
        ws = [w.detach().to(dtype).requires_grad_(True) for w in w32]
        return resnet56_pass(x32.to(dtype), ws, conv, convs, blocks, probe)

    # the oracle: the same pass in float64 through cuDNN, one client at a
    # time.  Rounding compounds over the 56 layers behind a gradient (and
    # flips ReLU masks), so a float32 pass sits about 1e-3 from it and a
    # bfloat16 pass about 1e-1: the kernels' pass, in each dtype, must sit
    # no farther from it than the library arm's (relative L2 of y, and of
    # all 57 dw together)
    y_64, dw_64 = run(_f64_conv, torch.float64)

    def dist(out):
        return _rel(out[0], y_64), _rel(_cat(out[1]), _cat(dw_64))

    f32_err = dist(run(kernel_conv, torch.float32))
    lib_f32_err = dist(run(library_conv, torch.float32))
    # the main path, bfloat16, counted
    torch.cuda.synchronize()
    reset_launches()
    mcc.LIBRARY_CALLS.update(dx=0, fwd=0)
    y_k, dw_k = run(kernel_conv, torch.bfloat16)
    torch.cuda.synchronize()
    launches = read_launches()
    lib_dx = mcc.LIBRARY_CALLS["dx"]
    check(launches["mc_conv.fwd"] == 57 + 52
          and launches["mc_conv.wgrad"] == 57 and lib_dx == 4
          and mcc.LIBRARY_CALLS["fwd"] == 0,
          f"phase {n}: launches fwd {launches['mc_conv.fwd']} (want 109), "
          f"wgrad {launches['mc_conv.wgrad']} (want 57), library dx "
          f"{lib_dx} (want 4), library forwards "
          f"{mcc.LIBRARY_CALLS['fwd']} (want 0)")
    check(tuple(y_k.shape) == (MC_K, MC_B, 8, 8, 64)
          and bool(torch.isfinite(y_k.float()).all())
          and all(bool(torch.isfinite(d.float()).all()) for d in dw_k),
          f"phase {n}: non-finite or misshapen pass output")
    bf16_err = dist((y_k, dw_k))
    lib_err = dist(run(library_conv, torch.bfloat16))
    for label, got, lib in (("float32", f32_err, lib_f32_err),
                            ("bfloat16", bf16_err, lib_err)):
        check(all(a <= 1.25 * b + 1e-4 for a, b in zip(got, lib)),
              f"phase {n}: {label} pass vs the float64 one, relative L2 of "
              f"y and of all dw: kernels {got}, library arm {lib}")

    def kernel_pass():
        return run(kernel_conv, torch.bfloat16)

    def library_pass():
        return run(library_conv, torch.bfloat16)

    k1 = _time_pass(kernel_pass)
    lp = _time_pass(library_pass)
    k2 = _time_pass(kernel_pass)
    kb, kb_ours = _busy_ms(kernel_pass)
    lb, _ = _busy_ms(library_pass)
    bound = 0.0
    for i, (h, ci, co, k, s) in enumerate(convs):
        kinds = ["fwd", "wgrad"] + (["dx"] if i else [])
        for kind in kinds:
            bound += _bound(*mc_work(h, ci, co, k, s, kind), card,
                            peak="bf16")[0]
    ms = statistics.median([k1[0], k2[0]])
    phase(n, "main path", f"multi-client conv: ResNet-56's 57 convs in "
          f"network order (with its ReLUs and residual adds, no BatchNorm), "
          f"K {MC_K} clients with per-client weights, B {MC_B}, bf16, "
          f"forward and backward through conv_for_clients: launches "
          f"mc_conv.fwd {launches['mc_conv.fwd']} (57 forwards + 52 dx), "
          f"mc_conv.wgrad {launches['mc_conv.wgrad']}, library dx {lib_dx}; "
          f"relative L2 to the float64 pass (cuDNN, one client at a time), "
          f"y / all dw: f32 kernels {f32_err[0]:.2e} / {f32_err[1]:.2e}, "
          f"f32 library arm {lib_f32_err[0]:.2e} / {lib_f32_err[1]:.2e}, "
          f"bf16 kernels {bf16_err[0]:.2e} / {bf16_err[1]:.2e}, bf16 "
          f"library arm {lib_err[0]:.2e} / {lib_err[1]:.2e}")
    phase(n, "main path", f"one pass, device clock from its first launch "
          f"to its last (median of 10; idle gaps included) / host wall: "
          f"kernels {k1[0]:.3f} / {k1[1]:.3f} and {k2[0]:.3f} / "
          f"{k2[1]:.3f} ms, library arm (one grouped F.conv2d a conv) "
          f"{lp[0]:.3f} / {lp[1]:.3f} ms -> kernels / library arm "
          f"{ms / lp[0]:.2f}x")
    phase(n, "main path", f"one pass, device busy (summed kernel times, "
          f"torch.profiler): kernels {kb:.3f} ms (mc_conv kernels "
          f"{kb_ours:.3f}), library arm {lb:.3f} ms; summed bound of the "
          f"pass's 57 forwards, 56 dx and 57 dw {bound:.4f} ms -> kernels "
          f"{bound / kb:.2%}, library arm {bound / lb:.2%} of it; kernels / "
          f"library arm {kb / lb:.2f}x")
    return launches


# --------------------------------------------- ops/pallas_ops: kernels 7–9
#: the serving path's GPT-2-small widths (benchmarks/serve_bench.py:107-108)
GPT2 = dict(vocab=50257, dim=768, layers=12, max_len=640)
DECODE_BATCH = 64
#: int8 weights of the blocks: wq, wk, wv, wo, w1 and w2 are 12·dim²
GPT2_INT8_WEIGHTS = GPT2["layers"] * 12 * GPT2["dim"] ** 2


def _order_err(got, ref, abs_ref, n, label):
    """Max |got − ref| of float32 sums of ``n`` terms taken in two orders,
    checked against n · 2^-24 · ``abs_ref`` (the same sums over |terms|)."""
    check(got.dtype == ref.dtype and got.shape == ref.shape,
          f"{label}: kernel gave {got.dtype} {tuple(got.shape)}, plain "
          f"version {ref.dtype} {tuple(ref.shape)}")
    check(bool(torch.isfinite(got).all()), f"{label}: non-finite output")
    diff = (got - ref).abs()
    bound = n * 2.0 ** -24 * abs_ref + 1e-30
    check(bool((diff <= bound).all()),
          f"{label}: kernel vs plain max |err| {float(diff.max()):.3g} past "
          f"{n}·2^-24·Σ|terms|")
    return float(diff.max())


def _offset(t, k):
    """``t``'s values starting ``k`` elements into a fresh storage (not
    16-byte aligned for k = 1)."""
    if not k:
        return t
    buf = torch.empty(t.numel() + k, dtype=t.dtype, device=t.device)
    out = buf[k:].view(t.shape)
    out.copy_(t)
    return out


def _wavg_check(x, w, label):
    got = po.weighted_average_flat(x, w)
    torch.cuda.synchronize()
    ref = po.weighted_average_flat_reference(x, w)
    wn = po.normalized_weights(w)
    return _order_err(got, ref, wn.abs() @ x.float().abs(), x.shape[0],
                      label)


def _wavg_tree_forms(dev, gen):
    """``agg_stacked_pallas`` in its by-value and table forms, on trees of
    float32 and bfloat16 leaves of every size mod 4, each starting 0-3
    elements into its storage (the table form past the by-value capacity):
    every leaf bit for bit the flat form's columns over the leaves
    concatenated, one launch a call."""
    c = 5
    layouts = {"by_value": [1, 2, 3, 4, 5, 130, 33, 1027, 1, 4093, 16, 3000],
               "table": [1 + (7 * i) % 13
                         for i in range(po.LEAF_CAPACITY + 16)]}
    done = {}
    for form, sizes in layouts.items():
        leaves = [_offset(torch.randn(c, n, generator=gen).to(
            torch.bfloat16 if i % 3 == 1 else torch.float32).to(dev), i % 4)
                  for i, n in enumerate(sizes)]
        w = torch.randint(1, 600, (c,), generator=gen).to(dev)
        check(po.weighted_average_form(sizes) == form,
              f"agg_stacked_pallas: {len(sizes)} leaves take the "
              f"{po.weighted_average_form(sizes)} form, not {form}")
        before = po.WAVG_FORMS[form]
        got = po.agg_stacked_pallas(leaves, w)
        torch.cuda.synchronize()
        check(po.WAVG_FORMS[form] == before + 1,
              f"agg_stacked_pallas: no {form} launch")
        flat = po.weighted_average_flat(torch.cat([leaf.float()
                                                   for leaf in leaves], 1), w)
        off = 0
        for leaf, out, n in zip(leaves, got, sizes):
            check(torch.equal(out, flat[off:off + n].to(leaf.dtype)),
                  f"agg_stacked_pallas ({form}): a leaf of {n} values "
                  f"differs from the flat form's bits")
            off += n
        done[form] = len(sizes)
    return done


def _qmask_inputs(d, gen):
    """x with ±40000 (past int32 once scaled), ±inf, NaN and exact halves
    2^-17·(2k+1); masks near 2^32 − 1 (int32 −1, −2, ...) that wrap."""
    x = torch.randn(d, generator=gen)
    edge = torch.cat([torch.tensor([40000.0, -40000.0, float("inf"),
                                    -float("inf"), float("nan"), 32768.0]),
                      2.0 ** -17 * (2 * torch.arange(-20, 20) + 1).float()])
    x[:min(d, edge.numel())] = edge[:d]
    m = torch.randint(-2 ** 31, 2 ** 31, (d,), generator=gen,
                      dtype=torch.int32)
    m[:min(d, 64)] = -1 - torch.arange(min(d, 64), dtype=torch.int32)
    return x, m


def _mm_check(x, q, s, label):
    got = po.int8_matmul(x, q, s)
    torch.cuda.synchronize()
    ref = po.int8_matmul_reference(x, q, s)
    return _order_err(got, ref, po.int8_matmul_reference(x.abs(), q.abs(), s),
                      q.shape[0], label)


def gpt2_params(dev, seed=15):
    """A seeded parameter dict in the JAX package's ``init_lm_params``
    layout (``fedml_tpu/parallel/seq_parallel.py:38-62``) at GPT-2-small
    widths, made on the card."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    dim, v = GPT2["dim"], GPT2["vocab"]

    def normal(*shape, scale):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    def ln():
        return {"scale": torch.ones(dim, device=dev),
                "bias": torch.zeros(dim, device=dev)}

    s = 1.0 / math.sqrt(dim)
    return {
        "embed": normal(v, dim, scale=0.02),
        "pos": normal(GPT2["max_len"], dim, scale=0.02),
        "ln_f": ln(),
        "blocks": [{"ln1": ln(), "wq": normal(dim, dim, scale=s),
                    "wk": normal(dim, dim, scale=s),
                    "wv": normal(dim, dim, scale=s),
                    "wo": normal(dim, dim, scale=s), "ln2": ln(),
                    "w1": normal(dim, 4 * dim, scale=s),
                    "w2": normal(4 * dim, dim, scale=s / 2.0)}
                   for _ in range(GPT2["layers"])],
    }


def decode_matrices(qparams):
    """One decode step's 72 int8 products, (q, s) in block order."""
    return [(blk[k]["q"], blk[k]["s"]) for blk in qparams["blocks"]
            for k in _MATMUL_KEYS]


def decode_inputs(m, dev, seed):
    """Seeded activations ``{K: [m, K]}`` for the products' two widths."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    dim = GPT2["dim"]
    return {k: torch.randn(m, k, generator=gen, device=dev)
            for k in (dim, 4 * dim)}


def decode_work(mats, m):
    """(bytes, FLOPs) of one decode step's products at batch m: each int8
    weight, scale, activation and output moved once."""
    nbytes = sum(q.numel() + 4 * (q.shape[1] + m * q.shape[0]
                                  + m * q.shape[1]) for q, _ in mats)
    return nbytes, sum(2 * m * q.numel() for q, _ in mats)


def int8_bound(nbytes, flops, m, card, dev):
    """The int8 product's bound at batch ``m``: the bytes at the memory
    rate against the operations of the path the kernel takes there (on the
    tensor cores, 3 bf16 passes of float32 x at the dense bf16 rate; on the
    CUDA cores, one pass at the float32 rate); (ms, which, both figures)."""
    plan = po.int8_matmul_plan(m, GPT2["dim"], GPT2["dim"], torch.float32,
                               dev)
    tensor = plan["path"] == "tensor"
    passes = 3 if tensor else 1
    bound_ms, bound_by = _bound(nbytes, passes * flops, card,
                                peak="bf16" if tensor else "f32")
    bw, f32, bf16 = card_peaks(card)
    rate = bf16 if tensor else f32
    text = (f"bytes {nbytes / 1e6:.1f} MB at {bw / 1e12:.2f} TB/s = "
            f"{nbytes / bw * 1e3:.4f} ms; operations {passes} x "
            f"{flops / 1e9:.2f} GFLOP at {rate / 1e12:.0f} TFLOP/s "
            f"({'bf16 tensor cores' if tensor else 'float32 CUDA cores'}, the "
            f"{plan['path']} path) = {passes * flops / rate * 1e3:.4f} ms")
    return bound_ms, bound_by, text


#: traces of one call that ``_device_kernels`` makes at most until the
#: profiler records a device activity: on the H100 machines a trace of a
#: few short kernels sometimes comes back with none at all, though the
#: kernels ran (a trace that records nothing shows nothing)
TRACE_ATTEMPTS = 5


def _device_kernels(fn):
    """The names of the device activities ``torch.profiler`` records over
    one call of ``fn``, the profiler's second step, ``TRACE_PAD_S`` from
    either edge of its window: its first, a warm-up call, absorbs the
    activities a trace loses as it starts.  A trace that records none is
    made again, up to ``TRACE_ATTEMPTS`` times; fails where none records
    any: the count is what the phase checks."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    for _ in range(TRACE_ATTEMPTS):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1)) as prof:
            fn()
            torch.cuda.synchronize()
            time.sleep(TRACE_PAD_S)
            prof.step()
            time.sleep(TRACE_PAD_S)
            fn()
            torch.cuda.synchronize()
            time.sleep(TRACE_PAD_S)
        kernels = [e.name for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and not e.name.startswith("ProfilerStep")]
        if kernels:
            return kernels
    check(False, f"the profiler recorded no device activity in "
          f"{TRACE_ATTEMPTS} traces")


def _graph_nodes(fn):
    """The kinds of the nodes of the CUDA graph that one call of ``fn``
    captures (after a warm-up call): every device operation the call
    enqueues, each kernel, copy and fill its own node.  The profiler cannot
    count a call of the tree form's kernel: on the H100 machines its traces
    seldom record a kernel that takes an 8 KB parameter."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    torch.cuda.synchronize()
    kinds = [kind for kind, _ in graph_nodes(graph)]
    graph.reset()
    return kinds


def po_kernel_phase(dev):
    """Kernels B7, B8 and B9 against their plain versions on the card: the
    CPU tests' cases, weights of every kernel type, ragged and misaligned
    operands, and the shapes of phase 15."""
    gen = torch.Generator().manual_seed(15)
    errs = {}
    w_err = {}
    for label, c, d, dtype, wkind, off in (
            ("jax_test", 10, 3000, torch.float32, "float", 0),
            ("zero_weights", 10, 3000, torch.float32, "some_zero", 0),
            ("all_zero", 4, 777, torch.float32, "zero", 0),
            ("one_client", 1, 777, torch.float32, "float", 0),
            ("int64_ragged", 10, 3001, torch.float32, "int64", 0),
            ("bf16", 6, 1024, torch.bfloat16, "int32", 0),
            ("misaligned", 10, 3000, torch.float32, "float", 1),
            ("resnet56", 10, 860026, torch.float32, "int32", 0)):
        x = _offset(torch.randn(c, d, generator=gen).to(dtype).to(dev), off)
        if wkind in ("int32", "int64"):
            w = torch.randint(1, 600, (c,), generator=gen,
                              dtype=getattr(torch, wkind))
        else:
            w = torch.rand(c, generator=gen)
            if wkind == "some_zero":
                w[::3] = 0.0
            elif wkind == "zero":
                w.zero_()
        w_err[label] = _wavg_check(x, w.to(dev), f"weighted_average {label}")
    # rows at every offset from a 16-byte boundary, and the tree forms,
    # from a generator of their own
    gen_rows = torch.Generator().manual_seed(19)
    for label, c, d, dtype, off in (
            ("d_mod4_1_offset_2", 10, 3001, torch.float32, 2),
            ("d_mod4_3_offset_3", 10, 3003, torch.float32, 3),
            ("bf16_offset_1", 6, 1025, torch.bfloat16, 1)):
        x = _offset(torch.randn(c, d, generator=gen_rows).to(dtype).to(dev),
                    off)
        w = torch.randint(1, 600, (c,), generator=gen_rows,
                          dtype=torch.int32)
        w_err[label] = _wavg_check(x, w.to(dev), f"weighted_average {label}")
    errs["pallas_ops.weighted_average"] = max(w_err.values())
    tree_forms = _wavg_tree_forms(dev, gen_rows)

    n_words = 0
    for d, dtype, off in ((777, torch.float32, 0), (1, torch.float32, 0),
                          (1025, torch.bfloat16, 0), (777, torch.float32, 1),
                          (860026, torch.float32, 0)):
        x, m = _qmask_inputs(d, gen)
        x = x.to(dtype)
        xc, mc = _offset(x.to(dev), off), _offset(m.to(dev), off)
        got = po.quantize_mask(xc, mc)
        torch.cuda.synchronize()
        check(torch.equal(got, po.quantize_mask_reference(xc, mc))
              and torch.equal(got.cpu(), po.quantize_mask(x, m)),
              f"quantize_mask D {d} {dtype} offset {off}: the kernel's words "
              f"differ from the plain version's on the card or the CPU")
        n_words += d
    errs["pallas_ops.quantize_mask"] = 0.0

    m_err = {}
    dim = GPT2["dim"]
    for label, m, k, n, dtype, q_off, pad in (
            ("jax_test", 4, 48, 700, torch.float32, 0, 0),
            ("m1_bf16", 1, 48, 700, torch.bfloat16, 0, 0),
            ("wq_m1", 1, dim, dim, torch.float32, 0, 0),
            ("wq_m64", 64, dim, dim, torch.float32, 0, 0),
            ("w1_m64", 64, dim, 4 * dim, torch.float32, 0, 0),
            ("w2_m64_bf16", 64, 4 * dim, dim, torch.bfloat16, 0, 0),
            ("ragged", 17, 100, 203, torch.float32, 0, 0),
            ("misaligned_q", 8, 64, 256, torch.float32, 1, 0),
            ("strided_x", 5, 96, 128, torch.float32, 0, 7),
            ("m2", 2, dim, dim, torch.float32, 0, 0),
            ("m8_k48", 8, 48, dim, torch.float32, 0, 0),
            ("m9", 9, dim, dim, torch.float32, 0, 0),
            ("m16_bf16", 16, dim, dim, torch.bfloat16, 0, 0),
            ("m32_k100", 32, 100, 203, torch.float32, 0, 0),
            ("m130", 130, 256, 192, torch.float32, 0, 0)):
        qs = quantize_matrix_int8(torch.randn(k, n, generator=gen).to(dev)
                                  * k ** -0.5)
        x = torch.randn(m, k + pad, generator=gen).to(dtype).to(dev)[:, :k]
        m_err[label] = _mm_check(x, _offset(qs["q"], q_off), qs["s"],
                                 f"int8_matmul {label}")
    errs["pallas_ops.int8_matmul"] = max(m_err.values())
    phase(3, "kernels", "pallas_ops weighted_average vs plain version, max "
          "|err| (tolerance C·2^-24·Σ_c|wn_c x_c|): " + ", ".join(
              f"{k} {v:.2e}" for k, v in w_err.items())
          + "; agg_stacked_pallas bit for bit the flat form over the "
          "concatenation in each form: " + ", ".join(
              f"{form} ({n} leaves)" for form, n in tree_forms.items())
          + f"; quantize_mask bit for bit over 5 cases ({n_words} words: "
          f"±40000, ±inf, NaN, halves, wrapping masks, bf16, misaligned, "
          f"D 860,026) on the card and against the CPU; int8_matmul vs "
          f"plain version (tolerance K·2^-24·(|x|@|q|)·s): " + ", ".join(
              f"{k} {v:.2e}" for k, v in m_err.items()))
    return errs


def _hidden(fn):
    """``_time_ms``'s sleep for ``fn``: three times the host time of one
    call to enqueue (at the H100's 1.98 GHz boost), at least
    ``HIDE_CYCLES``."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dict(hide=True, hide_cycles=max(HIDE_CYCLES,
                                           int(3 * host_s * 1.98e9)))


def po_timing_phase(dev, card):
    """Kernels B7 and B8 at ResNet-56's 860,026 values (B7 over 10 clients,
    integer weights), B9 over one GPT-2-small decode step's 72 products at
    M = 64 and M = 1: cold L2, median of 50, kernel and plain version in
    turns, and a single PyTorch call where one computes the same function
    (B7: ``torch.matmul(wn[None], x)``; B9: ``_weight_int8pack_mm`` where
    the card's PyTorch takes CUDA tensors)."""
    gen = torch.Generator(device=dev).manual_seed(16)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    rows = {}
    c, d = 10, 860026
    x = torch.randn(c, d, generator=gen, device=dev)
    w = torch.randint(100, 900, (c,), generator=gen, device=dev,
                      dtype=torch.int32)
    wn = po.normalized_weights(w)
    p1 = _time_ms(lambda: po.weighted_average_flat_reference(x, w), flush,
                  hide=True)
    k1 = _time_ms(lambda: po.weighted_average_flat(x, w), flush,
                  hide=True)
    lib = _time_ms(lambda: torch.matmul(wn[None], x), flush,
                  hide=True)
    k2 = _time_ms(lambda: po.weighted_average_flat(x, w), flush,
                  hide=True)
    p2 = _time_ms(lambda: po.weighted_average_flat_reference(x, w), flush,
                  hide=True)
    nbytes = (c + 1) * d * 4 + c * 4
    bound_ms, bound_by = _bound(nbytes, 2 * c * d, card)
    ms = statistics.median([k1, k2])
    rows["pallas_ops.weighted_average"] = dict(
        ms=ms, plain_ms=statistics.median([p1, p2]), library_ms=lib,
        bound_ms=bound_ms, bound_by=bound_by)
    phase(4, "timing", f"pallas_ops.weighted_average at [10, {d}] f32, int32 "
          f"weights, cold L2, host hidden, median of 50: kernel {k1:.4f} / "
          f"{k2:.4f} ms, "
          f"plain {p1:.4f} / {p2:.4f} ms, library matmul(wn[None], x) "
          f"{lib:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
          f"{nbytes / 1e6:.2f} MB) -> {bound_ms / ms:.1%} of the bound")
    del x

    # the tree form over phase 15's stacked ResNet-56 tree: the whole call,
    # against the design that concatenates the leaves first
    stacked, counts = resnet56_stacked(
        dev, torch.Generator(device=dev).manual_seed(18))
    tree = lambda: po.agg_stacked_pallas(stacked, counts)    # noqa: E731
    by_cat = lambda: agg_by_concatenation(stacked, counts)   # noqa: E731
    form = po.weighted_average_form([leaf[0].numel()
                                     for leaf in tree_leaves(stacked)])
    t1 = _time_ms(tree, flush, **_hidden(tree))
    c1 = _time_ms(by_cat, flush, **_hidden(by_cat))
    c2 = _time_ms(by_cat, flush, **_hidden(by_cat))
    t2 = _time_ms(tree, flush, **_hidden(tree))
    nbytes = (c + 1) * d * 4 + c * counts.element_size()
    tree_bound, tree_by = _bound(nbytes, 2 * c * d, card)
    t_ms = statistics.median([t1, t2])
    phase(4, "timing", f"pallas_ops.weighted_average at ResNet-56's "
          f"stacked tree ({len(tree_leaves(stacked))} leaves, [10, {d}] "
          f"f32, int64 weights), the whole agg_stacked_pallas call "
          f"({form} form), cold L2, host hidden, median of 50: {t1:.4f} / "
          f"{t2:.4f} ms, bound {tree_bound:.4f} ms ({tree_by}: "
          f"{nbytes / 1e6:.2f} MB) -> {tree_bound / t_ms:.1%} of the bound; "
          f"the leaves concatenated first, then the flat kernel: "
          f"{c1:.4f} / {c2:.4f} ms")
    del stacked

    xq = torch.randn(d, generator=gen, device=dev) * 0.01
    mq = torch.randint(-2 ** 31, 2 ** 31, (d,), generator=gen, device=dev,
                       dtype=torch.int32)
    p1 = _time_ms(lambda: po.quantize_mask_reference(xq, mq), flush,
                  hide=True)
    k1 = _time_ms(lambda: po.quantize_mask(xq, mq), flush,
                  hide=True)
    k2 = _time_ms(lambda: po.quantize_mask(xq, mq), flush,
                  hide=True)
    p2 = _time_ms(lambda: po.quantize_mask_reference(xq, mq), flush,
                  hide=True)
    nbytes = 12 * d
    bound_ms, bound_by = _bound(nbytes, 3 * d, card)
    ms = statistics.median([k1, k2])
    rows["pallas_ops.quantize_mask"] = dict(
        ms=ms, plain_ms=statistics.median([p1, p2]), library_ms=None,
        bound_ms=bound_ms, bound_by=bound_by)
    phase(4, "timing", f"pallas_ops.quantize_mask at D {d} f32, cold L2, "
          f"host hidden, median of 50: kernel {k1:.4f} / {k2:.4f} ms, plain "
          f"{p1:.4f} / "
          f"{p2:.4f} ms, library none (no single PyTorch call rounds to "
          f"int32 with saturation and adds modulo 2^32), bound "
          f"{bound_ms:.4f} ms ({bound_by}: {nbytes / 1e6:.2f} MB) -> "
          f"{bound_ms / ms:.1%} of the bound")

    mats = decode_matrices(quantize_lm_params(gpt2_params(dev)))
    check(len(mats) == 72, f"{len(mats)} decode products")
    # the library call takes the weights as [N, K] int8 and the scales in
    # x's dtype, prepared once outside the timing
    packed = [(q.t().contiguous(), s) for q, s in mats]
    mm_rows = {}
    for m in (DECODE_BATCH, 1):
        xs = decode_inputs(m, dev, seed=17 + m)

        def kernel():
            for q, s in mats:
                po.int8_matmul(xs[q.shape[0]], q, s)

        def plain():
            for q, s in mats:
                po.int8_matmul_reference(xs[q.shape[0]], q, s)

        def library():
            for qt, s in packed:
                torch.ops.aten._weight_int8pack_mm(xs[qt.shape[1]], qt, s)

        lib_note, lib_err = None, None
        try:
            q0, s0 = mats[0]
            lib_err = float((torch.ops.aten._weight_int8pack_mm(
                xs[q0.shape[0]], packed[0][0], s0)
                - po.int8_matmul_reference(xs[q0.shape[0]], q0, s0))
                .abs().max())
        except (RuntimeError, NotImplementedError) as e:
            lib_note = str(e).splitlines()[0][:120]
        # the host enqueues 72 calls behind a GPU sleep three times as long
        # as that takes, so the interval holds device time alone
        p1 = _time_ms(plain, flush, **_hidden(plain))
        k1 = _time_ms(kernel, flush, **_hidden(kernel))
        lib = (None if lib_note else
               _time_ms(library, flush, **_hidden(library)))
        k2 = _time_ms(kernel, flush, **_hidden(kernel))
        p2 = _time_ms(plain, flush, **_hidden(plain))
        nbytes, flops = decode_work(mats, m)
        bound_ms, bound_by, bound_text = int8_bound(nbytes, flops, m, card,
                                                    dev)
        ms = statistics.median([k1, k2])
        mm_rows[m] = dict(ms=ms, plain_ms=statistics.median([p1, p2]),
                          library_ms=lib, bound_ms=bound_ms,
                          bound_by=bound_by)
        lib_text = (f"_weight_int8pack_mm on [N, K] int8 {lib:.4f} ms (vs "
                    f"plain max |err| {lib_err:.2e})" if lib is not None
                    else f"none (_weight_int8pack_mm on CUDA tensors "
                         f"raised: {lib_note})")
        phase(4, "timing", f"pallas_ops.int8_matmul over one decode step's "
              f"72 products (GPT-2-small widths, {GPT2_INT8_WEIGHTS} int8 "
              f"weights) at M {m}, f32 x, cold L2, median of 50: kernel "
              f"{k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms, "
              f"library {lib_text} (the plain version is the cuBLAS pair "
              f"matmul(x, f32(q)) * s); bound {bound_ms:.4f} ms ({bound_by}; "
              f"{bound_text}) -> {bound_ms / ms:.1%} of the bound")
    rows["pallas_ops.int8_matmul"] = mm_rows[DECODE_BATCH]
    return rows


def resnet56_stacked(dev, gen):
    """A stacked ``MC_K``-client ResNet-56 variable tree on ``dev`` (each
    leaf the module's, perturbed per client) and the clients' sample
    counts (int64) as its weights, drawn from ``gen`` (on ``dev``)."""
    tree = tree_from_module(CIFARResNet(depth=56, num_classes=10))
    stacked = tree_map(lambda leaf: leaf.to(dev)[None] + 0.01 * torch.randn(
        (MC_K,) + tuple(leaf.shape), generator=gen, device=dev), tree)
    counts = torch.randint(100, 900, (MC_K,), generator=gen, device=dev)
    return stacked, counts


def agg_by_concatenation(stacked_tree, weights, flat_fn=None):
    """The tree form of the weighted average as the JAX wrapper builds it:
    the leaves cast and concatenated into one float32 ``[C, D]``, one flat
    average (``flat_fn``, by default the port's ``weighted_average_flat``),
    the result cut into leaves and each cast back to its dtype.  The
    yardstick that ``agg_stacked_pallas`` reads the leaves in place
    against."""
    flat_fn = flat_fn or po.weighted_average_flat
    leaves = tree_leaves(stacked_tree)
    c = leaves[0].shape[0]
    avg = flat_fn(torch.cat([leaf.reshape(c, -1).float()
                             for leaf in leaves], dim=1), weights)
    out, off = [], 0
    for leaf in leaves:
        size = leaf[0].numel()
        out.append(avg[off:off + size].reshape(leaf.shape[1:])
                   .to(leaf.dtype))
        off += size
    return out


def po_main_path_phase(n, dev):
    """Kernels B7, B8 and B9 through their public entries at widths the
    repo runs; the launch counts set to 0 before each path and read after."""
    launches = {}
    # B7: a stacked 10-client ResNet-56 variable tree, each leaf perturbed
    # per client, weights the clients' sample counts
    gen = torch.Generator(device=dev).manual_seed(18)
    stacked, counts = resnet56_stacked(dev, gen)
    leaves = tree_leaves(stacked)
    d = sum(leaf[0].numel() for leaf in leaves)
    check(d == 860026, f"ResNet-56 has {d} variables")
    torch.cuda.synchronize()
    reset_launches()
    avg = po.agg_stacked_pallas(stacked, counts)
    torch.cuda.synchronize()
    got = read_launches()
    check(got["pallas_ops.weighted_average"] == 1,
          f"phase {n}: agg_stacked_pallas launched "
          f"{got['pallas_ops.weighted_average']} weighted averages, not 1")
    launches["pallas_ops.weighted_average"] = got[
        "pallas_ops.weighted_average"]
    forms = {k.split(".")[1]: n for k, n in got.items()
             if k.startswith("weighted_average_form.") and n}
    # the same call captured as a CUDA graph: one kernel, no copy or cast
    nodes = _graph_nodes(lambda: po.agg_stacked_pallas(stacked, counts))
    check(nodes == ["kernel"], f"phase {n}: one agg_stacked_pallas call "
          f"enqueues {nodes}, not one kernel")
    flat = torch.cat([leaf.reshape(MC_K, -1) for leaf in
                      tree_leaves(stacked)], dim=1)
    out = torch.cat([leaf.reshape(-1) for leaf in tree_leaves(avg)])
    abs_sum = po.normalized_weights(counts).abs() @ flat.abs()
    e_plain = _order_err(out, po.weighted_average_flat_reference(flat,
                                                                 counts),
                         abs_sum, MC_K, f"phase {n}: agg_stacked_pallas")
    by_leaf = {str(i): leaf for i, leaf in enumerate(tree_leaves(stacked))}
    k1 = agg_stacked(by_leaf, counts.float())
    e_k1 = _order_err(out, torch.cat([k1[str(i)].reshape(-1)
                                      for i in range(len(by_leaf))]),
                      abs_sum, MC_K, f"phase {n}: against agg_stacked")
    phase(n, "main path", f"pallas_ops.agg_stacked_pallas over a stacked "
          f"{MC_K}-client ResNet-56 variable tree ({len(leaves)} leaves, "
          f"{d} values, integer sample counts): launches "
          f"{launches['pallas_ops.weighted_average']} weighted_average "
          f"(forms {forms}); the call captured as a CUDA graph holds "
          f"{len(nodes)} node: {nodes[0]}; max "
          f"|err| {e_plain:.2e} vs the plain version, {e_k1:.2e} vs "
          f"agg_stacked (kernel 1, one launch a leaf); tolerance "
          f"C·2^-24·Σ|terms|")
    del stacked, flat, avg, k1, by_leaf

    # B8: SecAgg's bulk round, 8 silos masking ResNet-56's flat update
    updates = [0.01 * torch.randn(d, generator=gen, device=dev)
               for _ in range(SILOS)]
    masks = [secagg.prg_mask_like({"update": u}, seed=1000 + i)["update"]
             for i, u in enumerate(updates)]
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    masked = [po.quantize_mask(u, m) for u, m in zip(updates, masks)]
    qsum, agg_mask = masked[0], masks[0]
    for w, m in zip(masked[1:], masks[1:]):
        qsum, agg_mask = qsum + w, agg_mask + m
    rec = secagg.dequantize(secagg.unmask_sum({"update": qsum},
                                              {"update": agg_mask}))["update"]
    torch.cuda.synchronize()
    round_ms = (time.perf_counter() - t0) * 1e3
    got = read_launches()
    check(got["pallas_ops.quantize_mask"] == SILOS,
          f"phase {n}: {got['pallas_ops.quantize_mask']} quantize_mask "
          f"launches for {SILOS} silos")
    launches["pallas_ops.quantize_mask"] = got["pallas_ops.quantize_mask"]
    for i, (u, m, w) in enumerate(zip(updates, masks, masked)):
        two_step = secagg.mask_model(secagg.quantize({"u": u}),
                                     {"u": m})["u"]
        check(torch.equal(w, two_step), f"phase {n}: silo {i}'s masked "
              f"words differ from mask_model(quantize(x))")
    exact = torch.stack(updates).double().sum(0)
    rec_err = float((rec.double() - exact).abs().max())
    check(rec_err <= SILOS * 2.0 ** -17, f"phase {n}: the unmasked sum is "
          f"{rec_err:.3g} from the float sum, past {SILOS}·2^-17")
    phase(n, "main path", f"SecAgg round over ResNet-56's {d} parameters, "
          f"{SILOS} silos: launches {launches['pallas_ops.quantize_mask']} "
          f"quantize_mask (one a silo), every silo's words bit for bit the "
          f"two-step mask_model(quantize(x)); the server's sum, unmasked and "
          f"dequantized, {rec_err:.3g} from the float sum (bound "
          f"{SILOS}·2^-17 = {SILOS * 2.0 ** -17:.3g}); masking, sum and "
          f"unmask {round_ms:.2f} ms of host wall")
    del updates, masks, masked, qsum, agg_mask, rec, exact

    # B9: one decode step's 72 int8 products at GPT-2-small widths
    params = gpt2_params(dev)
    qparams = quantize_lm_params(params)
    mats = decode_matrices(qparams)
    n_weights = sum(q.numel() for q, _ in mats)
    check(len(mats) == 72 and n_weights == GPT2_INT8_WEIGHTS
          and all(q.dtype == torch.int8 for q, _ in mats),
          f"phase {n}: {len(mats)} matrices, {n_weights} int8 weights")
    q_err = 0.0
    for blk, qblk in zip(params["blocks"], qparams["blocks"]):
        for k in _MATMUL_KEYS:
            # half a scale, and the float32 roundings of w / s and q · s
            err = (blk[k] - dequantize_matrix(qblk[k])).abs()
            check(bool((err <= (0.5 + 2.0 ** -16) * qblk[k]["s"]).all()),
                  f"phase {n}: {k} dequantizes more than half a scale off")
            q_err = max(q_err, float(err.max()))
    del params
    mm_err, mm_launches, traced = {}, 0, {}
    for m in (DECODE_BATCH, 1):
        xs = decode_inputs(m, dev, seed=19 + m)
        torch.cuda.synchronize()
        reset_launches()
        outs = [po.int8_matmul(xs[q.shape[0]], q, s) for q, s in mats]
        torch.cuda.synchronize()
        got = read_launches()
        check(got["pallas_ops.int8_matmul"] == len(mats),
              f"phase {n}: {got['pallas_ops.int8_matmul']} int8_matmul "
              f"launches at M {m}, not {len(mats)}")
        mm_launches += got["pallas_ops.int8_matmul"]
        # the same step under the profiler: one device kernel a product
        kernels = _device_kernels(
            lambda: [po.int8_matmul(xs[q.shape[0]], q, s) for q, s in mats])
        check(len(kernels) == len(mats),
              f"phase {n}: the trace of a decode step at M {m} holds "
              f"{len(kernels)} device kernels, not {len(mats)}: "
              f"{sorted(set(k[:60] for k in kernels))}")
        traced[m] = (len(kernels), sorted(set(k.split('<')[0]
                                              for k in kernels)))
        mm_err[m] = max(_order_err(
            o, po.int8_matmul_reference(xs[q.shape[0]], q, s),
            po.int8_matmul_reference(xs[q.shape[0]].abs(), q.abs(), s),
            q.shape[0], f"phase {n}: int8_matmul M {m}")
            for o, (q, s) in zip(outs, mats))
    launches["pallas_ops.int8_matmul"] = mm_launches
    card = torch.cuda.get_device_name(0)
    b1 = int8_bound(*decode_work(mats, 1), 1, card, dev)
    b64 = int8_bound(*decode_work(mats, DECODE_BATCH), DECODE_BATCH, card,
                     dev)
    trace_text = ("; device kernels a step in a torch.profiler trace: " +
                  ", ".join(f"M {m} {c} ({', '.join(names)})"
                            for m, (c, names) in traced.items()))
    phase(n, "main path", f"one decode step's int8 products at GPT-2-small "
          f"widths (dim {GPT2['dim']}, {GPT2['layers']} layers; "
          f"quantize_lm_params: {len(mats)} matrices, {n_weights} int8 "
          f"weights, max |w - dequant| {q_err:.3g}, within half a scale): "
          f"launches {mm_launches} int8_matmul ({len(mats)} at M "
          f"{DECODE_BATCH} and {len(mats)} at M 1); max |err| vs plain "
          f"{mm_err[DECODE_BATCH]:.2e} (M {DECODE_BATCH}), {mm_err[1]:.2e} "
          f"(M 1), tolerance K·2^-24·(|x|@|q|)·s; bound of the step: M 1 "
          f"{b1[0]:.4f} ms ({b1[1]}), M {DECODE_BATCH} {b64[0]:.4f} ms "
          f"({b64[1]}){trace_text}")
    return launches


#: the fused path: the north-star config in chunks of FUSED_FREQ rounds (an
#: eval after each), FUSED_ROUNDS in all; round 1 runs uncaptured
FUSED_ROUNDS = 8
FUSED_FREQ = 4
FUSED_CONFIG = dict(MAIN_CONFIG, comm_round=FUSED_ROUNDS,
                    frequency_of_the_test=FUSED_FREQ, fused_rounds=True)
#: the bit-for-bit check's cohort: ResNet-56 in bfloat16 on the north-star
#: data, 2 clients a round in 2 size strata capped at 0.25 (a north-star
#: round's 10 clients cost 6 s a round uncaptured; capped, each stratum's
#: larger clients still draw a rotating window)
FUSED_CHECK = dict(client_num_per_round=2, hetero_buckets=2,
                   hetero_bucket_cap=0.25)


def _graph_summary(api):
    """The captured round's nodes: (count, counts by kind as text, kernel
    names, seconds taken to read them)."""
    t0 = time.perf_counter()
    nodes = api.fused_graph_nodes()
    secs = time.perf_counter() - t0
    kinds = {}
    for kind, _ in nodes:
        kinds[kind] = kinds.get(kind, 0) + 1
    names = [n for kind, n in nodes if kind == "kernel"]
    text = ", ".join(f"{k} {v}" for k, v in sorted(kinds.items(),
                                                   key=lambda kv: -kv[1]))
    return len(nodes), text, names, secs


def _fused_chunk_checks(api, rounds, freq):
    """Check the chunks of a fused drive of ``rounds`` rounds, an eval
    every ``freq`` (the first round uncaptured, every later one a replay);
    rounds/s over the chunks of replays alone, None without one."""
    chunks = api.fused_stats["chunks"]
    want = [min(freq, rounds - i) for i in range(0, rounds, freq)]
    check([c["rounds"] for c in chunks] == want
          and [c["replays"] for c in chunks]
          == [want[0] - 1] + want[1:], f"chunks {chunks}")
    replayed = [c for c in chunks if c["replays"] == c["rounds"]]
    if not replayed:
        return None
    return (sum(c["rounds"] for c in replayed)
            / sum(c["seconds"] for c in replayed))


def _fused_drive(label, dataset=None, **overrides):
    """The fused path through the five steps: the launches of its
    uncaptured round and of the capture (replays do not count), the
    captured round's nodes by kind and its epilogue kernels, rounds/s of
    the replayed chunks."""
    run = _drive(dict(FUSED_CONFIG, **overrides), rounds=FUSED_ROUNDS,
                 dataset=dataset)
    api, launches = run["api"], run["launches"]
    stats = api.fused_stats
    chunks = stats["chunks"]
    rate = _fused_chunk_checks(api, FUSED_ROUNDS, FUSED_FREQ)
    evals = [m["round"] for m in api.metrics_history]
    check(evals == [FUSED_FREQ - 1, FUSED_ROUNDS - 1], f"evals at {evals}")
    n_nodes, kinds, names, t_nodes = _graph_summary(api)
    reduce = sum("weighted_reduce_kernel" in n for n in names)
    fused = sum("fused_epilogue_kernel" in n for n in names)
    groups = len(api.global_vars)
    fedopt = api.algo == "FedOpt"
    # the uncaptured round and the capture each launch the round's kernels
    want = (1, 1) if fedopt else (groups, 0)
    check((reduce, fused) == want,
          f"the captured round holds {reduce} weighted-reduce and {fused} "
          f"fused-epilogue nodes, not {want}")
    check(launches["weighted_reduce"] == 2 * want[0]
          and launches["fused_epilogue"] == 2 * want[1]
          and launches["fused_epilogue.adam"] == 2 * want[1],
          f"the uncaptured round and the capture launched {launches}")
    extra = ""
    if fedopt:
        t = api.server_state["opt_state"][torch.float32]["t"]
        check(isinstance(t, torch.Tensor) and int(t) == FUSED_ROUNDS,
              f"adam's step count {t}")
        extra = f", adam t {int(t)} on the device"
    final, args = run["final"], run["args"]
    phase(16, "main path", f"Parrot {label} fused rounds, {args.model} "
          f"{args.compute_dtype}, {api.n_total} clients, {api.n_buckets} "
          f"strata, {FUSED_ROUNDS} rounds in chunks of {FUSED_FREQ} (round 1 "
          f"uncaptured, then one capture, {sum(c['replays'] for c in chunks)}"
          f" replays): capture {stats['capture_s']:.2f} s, instantiate "
          f"{stats['instantiate_s']:.2f} s; {rate:.3f} rounds/s over the "
          f"replayed chunk (host clock, ended by reading its losses) against "
          f"the per-round path's {PER_ROUND_RATE.get(label, float('nan')):.3f}"
          f" (phases 6-7, after round 0); the round's graph: {n_nodes} "
          f"nodes ({kinds}; read in {t_nodes:.1f} s), epilogue kernels "
          f"{reduce} "
          f"weighted_reduce, {fused} fused_epilogue; launches outside "
          f"replays "
          + ", ".join(f"{k} {v}" for k, v in launches.items() if v)
          + f"{extra}; final test_acc {final['test_acc']:.4f} test_loss "
          f"{final['test_loss']:.4f}, peak memory {run['peak'] / 2**30:.2f} "
          f"GiB, data {run['t_data']:.1f} s, whole drive {run['total']:.1f} s")
    return launches, api, run["dataset"]


def trace_fused_chunk(api, rounds=1):
    """The device's busy share over one replayed chunk of ``rounds``
    rounds, as ``trace_phase`` measures it: the chunk timed once plainly
    on the host clock (ended by reading its losses), and once under
    ``torch.profiler`` for the device time of the activities it records,
    traced again where a trace records none (as ``_device_kernels``).
    The traced chunk's own wall is no yardstick: the profiler slows the
    launch of a graph of ~290k nodes on the host (in one run to 1.87 s
    from 0.79).  The activities are summed from the profiler's raw
    records, not its parsed event tree."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t_phase = time.perf_counter()

    def chunk():
        api._fused_chunk(rounds).cpu()

    t0 = time.perf_counter()
    chunk()
    wall = time.perf_counter() - t0
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        time.sleep(TRACE_PAD_S)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(TRACE_PAD_S)
            chunk()
            time.sleep(TRACE_PAD_S)
            t_stop = time.perf_counter()
        t_read = time.perf_counter()
        t_stop = t_read - t_stop
        spans = [e.duration_ns()
                 for e in prof.profiler.kineto_results.events()
                 if e.device_type() == DeviceType.CUDA]
        t_read = time.perf_counter() - t_read
        if spans:
            break
    check(bool(spans), f"the profiler recorded no device activity in "
          f"{TRACE_ATTEMPTS} traces of a replayed chunk")
    busy = sum(spans) / 1e9
    phase(16, "trace", f"one replayed chunk of {rounds} round(s) of the "
          f"FedOpt path: wall {wall:.3f} s, device busy {busy:.3f} s "
          f"({busy / wall:.1%}; idle {1 - busy / wall:.1%}), "
          f"{len(spans)} device activities (trace {attempt}); "
          f"{time.perf_counter() - t_phase:.1f} s, of which the profiler's "
          f"stop {t_stop:.1f} s and reading its records {t_read:.1f} s")
    return busy / wall


def _round_state(api):
    opt = api.server_state.get("opt_state", {})
    return {"global": {dt: f.clone() for dt, f in api.global_vars.items()},
            "opt": {dt: {k: v.clone() for k, v in (st or {}).items()
                         if isinstance(v, torch.Tensor)}
                    for dt, st in opt.items()},
            "gen": api._fgen.get_state()}


def _set_round_state(api, state):
    for dt, f in api.global_vars.items():
        f.copy_(state["global"][dt])
    for dt, st in api.server_state.get("opt_state", {}).items():
        for k, v in state["opt"][dt].items():
            st[k].copy_(v)
    api._fgen.set_state(state["gen"])


def fused_checks(api, dataset):
    """A replayed chunk under sync-debug mode "error"; then, under
    ``torch.use_deterministic_algorithms(True)``, 2 replayed rounds of a
    FedOpt ParrotAPI on ResNet-56 against 2 uncaptured runs of the same
    body from the same globals, server state and generator state, bit for
    bit (metrics, globals, adam's m, v and t, the generator's state)."""
    t_phase = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        rows = api._fused_chunk(2)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check(api._last_replays == 2 and bool(torch.isfinite(rows).all()),
          f"the chunk did not replay: {api._last_replays} replays, metrics "
          f"{rows}")

    args = fedml_tpu_torch.init(fedml_tpu_torch.Config(
        **dict(FUSED_CONFIG, **FEDOPT, **FUSED_CHECK)))
    torch.use_deterministic_algorithms(True)
    try:
        torch.manual_seed(0)
        bundle = fedml_tpu_torch.model.create(args, dataset[-1])
        small = ParrotAPI(args, None, dataset, bundle)
        small.run_rounds_fused(1)
        start = _round_state(small)
        replayed = small._fused_chunk(2).clone()
        after = _round_state(small)
        _set_round_state(small, start)
        rows = []
        for _ in range(2):
            small._fused_round()
            rows.append(small._rm.clone())
        eager = _round_state(small)
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    same = {"metrics": torch.equal(replayed, torch.stack(rows)),
            "generator": torch.equal(after["gen"], eager["gen"])}
    for dt in after["global"]:
        same[f"global {dt}"] = torch.equal(after["global"][dt],
                                           eager["global"][dt])
        for k, v in after["opt"][dt].items():
            same[f"{k} {dt}"] = torch.equal(v, eager["opt"][dt][k])
    check(all(same.values()), f"replayed and uncaptured rounds differ: "
          f"{same}")
    moved = not torch.equal(after["global"][torch.float32],
                            start["global"][torch.float32])
    check(moved, "the replayed rounds did not move the globals")
    phase(16, "checks", f"a replayed chunk of 2 rounds raised nothing under "
          f"sync-debug mode 'error'; under deterministic algorithms, 2 "
          f"replayed FedOpt rounds of ResNet-56 bf16 ({small.k} clients a "
          f"round in {small.n_buckets} strata capped at {small.bucket_cap}) "
          f"equal 2 uncaptured runs of "
          f"the round body from the same state, bit for bit: "
          + ", ".join(f"{k} {'equal' if v else 'DIFFER'}"
                      for k, v in same.items())
          + f"; adam t {int(after['opt'][torch.float32]['t'])}; "
          f"{time.perf_counter() - t_phase:.1f} s")


def fused_phase(name, dataset=None):
    """Phase 16: the fused rounds on the north-star config, FedAvg then
    FedOpt (server adam), then the trace and the checks.  ``dataset``:
    phases 6-7's data (the same config's), taken instead of loading it
    again."""
    avg_launches, api, dataset = _fused_drive("FedAvg", dataset)
    api = None
    opt_launches, api, _ = _fused_drive("FedOpt (server adam)", dataset,
                                        **FEDOPT)
    trace_fused_chunk(api)
    fused_checks(api, dataset)
    print(f"    card: {_smi_line()}", flush=True)
    return avg_launches, opt_launches


#: BASELINE config 3 fused (phase 17): phase 9's config with fused rounds,
#: 8 rounds in chunks of 4, an eval and a checkpoint after each
LM_FUSED_CONFIG = dict(
    LM_CONFIG, comm_round=FUSED_ROUNDS, frequency_of_the_test=FUSED_FREQ,
    fused_rounds=True,
    checkpoint_dir=os.path.join(ROOT, ".data_cache", "chip_smoke_ckpt"))
#: the unfused yogi arm fused (phase 17): ResNet-20 on the north-star data,
#: phase 16's check cohort, 3 rounds in one chunk (one uncaptured, 2
#: replays)
YOGI_FUSED = dict(FUSED_CONFIG, **FUSED_CHECK, model="resnet20",
                  federated_optimizer="FedOpt", server_optimizer="yogi",
                  server_lr=1e-3, comm_round=3, frequency_of_the_test=3)


def _equal_bits(a, b):
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == \
        b.tobytes()


def lm_fused_phase(lm_data, main_data):
    """Phase 17: BASELINE config 3 in fused rounds through the five steps
    (phase 9's data), its resume from the chunk-boundary checkpoint, and
    the unfused yogi arm fused on ResNet-20 (phase 16's data)."""
    t_phase = time.perf_counter()
    ck = LM_FUSED_CONFIG["checkpoint_dir"]
    shutil.rmtree(ck, ignore_errors=True)
    run = _drive(LM_FUSED_CONFIG, unit="tokens", rounds=FUSED_ROUNDS,
                 dataset=lm_data)
    api, launches, stats = run["api"], run["launches"], run["api"].fused_stats
    rate = _fused_chunk_checks(api, FUSED_ROUNDS, FUSED_FREQ)
    evals = [m["round"] for m in api.metrics_history]
    check(evals == [FUSED_FREQ - 1, FUSED_ROUNDS - 1], f"evals at {evals}")
    n_test = int(api.test_num)
    want_flash = 2 * (-(-n_test // api.bs)) * len(evals)
    check(launches["flash_attention"] == want_flash
          and launches["fused_epilogue.adam"] == 2
          and launches["fused_epilogue"] == 2
          and launches["weighted_reduce"] == 0,
          f"the uncaptured round, the capture and {len(evals)} evals of "
          f"{n_test} sequences launched {launches}; want flash_attention "
          f"{want_flash}, adam 2")
    n_nodes, kinds, names, _ = _graph_summary(api)
    fused = sum("fused_epilogue_kernel" in n for n in names)
    reduce = sum("weighted_reduce_kernel" in n for n in names)
    flash = sum("flash" in n for n in names)
    check((reduce, fused, flash) == (0, 1, 0),
          f"the captured config-3 round holds {reduce} weighted-reduce, "
          f"{fused} fused-epilogue and {flash} flash nodes, not (0, 1, 0)")
    t = api.server_state["opt_state"][torch.float32]["t"]
    check(isinstance(t, torch.Tensor) and int(t) == FUSED_ROUNDS
          and api._dgen is not None,
          f"adam's step count {t}, dropout generator {api._dgen}")
    ckpt = RoundCheckpointer(ck)
    saved = sorted(int(f[6:14]) for f in os.listdir(ck))
    check(saved == [FUSED_FREQ - 1, FUSED_ROUNDS - 1],
          f"checkpoints of rounds {saved}")
    losses = [r["train_loss"] for r in api.round_history]
    final, args = run["final"], run["args"]
    phase(17, "main path", f"BASELINE config 3 fused: Parrot FedOpt (server "
          f"adam {args.server_lr}) {args.model} {args.compute_dtype} "
          f"dropout {api.bundle.module.dropout} on {args.dataset}, "
          f"{api.n_total} clients, {api.k} per round (grids of {api.nb} "
          f"batches, every batch run and gated), {FUSED_ROUNDS} rounds in "
          f"chunks of {FUSED_FREQ} (round 1 uncaptured, one capture, "
          f"{sum(c['replays'] for c in stats['chunks'])} replays): capture "
          f"{stats['capture_s']:.2f} s, instantiate "
          f"{stats['instantiate_s']:.2f} s; {rate:.3f} rounds/s over the "
          f"replayed chunk (host clock, ended by reading its losses) against "
          f"the per-round path's "
          f"{PER_ROUND_RATE.get('config 3', float('nan')):.3f} (phase 9, "
          f"after round 0); the round's graph: {n_nodes} nodes ({kinds}), "
          f"{fused} fused_epilogue, {reduce} weighted_reduce, {flash} flash "
          f"(training at dropout 0.1 takes the plain attention); launches "
          f"outside replays: flash_attention {launches['flash_attention']} "
          f"in the {len(evals)} evals (2 per eval batch), "
          f"fused_epilogue.adam {launches['fused_epilogue.adam']}; adam t "
          f"{int(t)} on the device; train_loss by round "
          + ", ".join(f"{x:.4f}" for x in losses)
          + f"; final token test_acc {final['test_acc']:.4f} test_loss "
          f"{final['test_loss']:.4f}; checkpoints after rounds {saved}; "
          f"peak memory {run['peak'] / 2**30:.2f} GiB; whole drive "
          f"{run['total']:.1f} s")
    api = run = None

    # resume: a fresh API restores the chunk-boundary checkpoint in place,
    # checked bit for bit against the file, then captures and replays one
    # chunk with the seed train() gave the first drive's second chunk
    t0 = time.perf_counter()
    gc.collect()
    state = ckpt.restore(FUSED_FREQ - 1)
    args = fedml_tpu_torch.init(fedml_tpu_torch.Config(**LM_FUSED_CONFIG))
    torch.manual_seed(0)
    bundle = fedml_tpu_torch.model.create(args, lm_data[-1])
    fresh = ParrotAPI(args, None, lm_data, bundle)
    fresh._restore_state(state)
    got = fresh.global_flax_variables()
    g_leaves = tree_leaves(got)
    s_leaves = tree_leaves(state["global_vars"])
    same = {"global": len(g_leaves) == len(s_leaves) and all(
        _equal_bits(a, b) for a, b in zip(g_leaves, s_leaves))}
    st = fresh.server_state["opt_state"][torch.float32]
    src = state["server_state"]["opt_state"]["float32"]
    for k in ("m", "v"):
        same[k] = _equal_bits(st[k].cpu().numpy(), src[k])
    same["t"] = int(st["t"]) == int(src["t"]) == FUSED_FREQ
    check(all(same.values()), f"the restored state differs from the "
          f"checkpoint: {same}")
    gen = torch.Generator().manual_seed(int(args.random_seed)
                                        + SAMPLE_SEED_OFFSET)
    torch.randint(0, 1 << 62, (), generator=gen)     # the first chunk's seed
    t1 = time.perf_counter()
    rms = fresh.run_rounds_fused(FUSED_FREQ, rng=gen)
    t_chunk = time.perf_counter() - t1
    check(fresh._last_replays == FUSED_FREQ - 1
          and np.isfinite(rms["train_loss"]).all()
          and int(st["t"]) == FUSED_ROUNDS,
          f"the resumed chunk: {fresh._last_replays} replays, losses "
          f"{rms['train_loss']}, t {int(st['t'])}")
    first = np.asarray(losses[FUSED_FREQ:], np.float64)
    dl = np.abs(rms["train_loss"] - first) / np.abs(first)
    check(dl[0] <= 1e-2, f"the resumed chunk's first round trained other "
          f"rounds than the first drive's: train_loss {rms['train_loss']} "
          f"against {first}")
    phase(17, "resume", f"a fresh ParrotAPI restored the round-"
          f"{FUSED_FREQ - 1} checkpoint in place, "
          + ", ".join(f"{k} {'equal' if v else 'DIFFER'}"
                      for k, v in same.items())
          + f" to the file, bit for bit, before its first round; then one "
          f"chunk of {FUSED_FREQ} (round 1 uncaptured, a capture "
          f"{fresh.fused_stats['capture_s']:.2f} s + instantiate "
          f"{fresh.fused_stats['instantiate_s']:.2f} s, "
          f"{fresh._last_replays} replays) in {t_chunk:.1f} s with the "
          f"first drive's second-chunk seed: train_loss "
          + ", ".join(f"{x:.4f}" for x in rms["train_loss"])
          + " against the first drive's "
          + ", ".join(f"{x:.4f}" for x in first)
          + f" (relative difference {dl.max():.2e} at most); "
          f"{time.perf_counter() - t0:.1f} s")
    fresh = bundle = state = None

    yogi = _drive(YOGI_FUSED, rounds=YOGI_FUSED["comm_round"],
                  dataset=main_data)
    api, y_launches = yogi["api"], yogi["launches"]
    _fused_chunk_checks(api, YOGI_FUSED["comm_round"],
                        YOGI_FUSED["frequency_of_the_test"])
    chunk = api.fused_stats["chunks"][0]
    groups = len(api.global_vars)
    n_nodes, kinds, names, _ = _graph_summary(api)
    reduce = sum("weighted_reduce_kernel" in n for n in names)
    fused = sum("fused_epilogue_kernel" in n for n in names)
    count = api.server_state["opt_state"][torch.float32]["count"]
    check((reduce, fused) == (groups, 0)
          and y_launches["weighted_reduce"] == 2 * groups
          and y_launches["fused_epilogue"] == 0
          and isinstance(count, torch.Tensor)
          and int(count) == YOGI_FUSED["comm_round"],
          f"the unfused yogi round: {reduce} weighted-reduce and {fused} "
          f"fused-epilogue nodes, launches {y_launches}, count {count}")
    phase(17, "main path", f"the unfused yogi arm fused: {api.args.model} "
          f"{api.args.compute_dtype}, {api.k} clients a round in "
          f"{api.n_buckets} strata capped at {api.bucket_cap}, "
          f"{YOGI_FUSED['comm_round']} rounds in one chunk (round 1 "
          f"uncaptured, a capture, {chunk['replays']} replays): "
          f"capture {api.fused_stats['capture_s']:.2f} s, instantiate "
          f"{api.fused_stats['instantiate_s']:.2f} s, the chunk "
          f"{chunk['seconds']:.2f} s; the round's graph: {n_nodes} nodes "
          f"({kinds}), {reduce} "
          f"weighted_reduce (kernel 1, the arm's reduce), {fused} "
          f"fused_epilogue; optax's count {int(count)} on the device; "
          f"launches outside replays weighted_reduce "
          f"{y_launches['weighted_reduce']}; final test_acc "
          f"{yogi['final']['test_acc']:.4f}; whole drive "
          f"{yogi['total']:.1f} s; phase 17 {time.perf_counter() - t_phase:.1f}"
          f" s")
    print(f"    card: {_smi_line()}", flush=True)
    shutil.rmtree(ck, ignore_errors=True)
    return launches, y_launches


#: phase 18's arms, each with the setting named in its line
ARMS = (("FedProx", dict(fedprox_mu=0.1)), ("FedNova", {}),
        ("SCAFFOLD", {}), ("FedDyn", dict(feddyn_alpha=0.01)),
        ("Mime", dict(server_momentum=0.9)))
ARM_ROUNDS = 2
#: the fused arms on ResNet-20, phase 16's check cohort: 3 rounds in one
#: chunk (one uncaptured, 2 replays), then 2 more replays timed alone
ARM_FUSED = dict(FUSED_CONFIG, **FUSED_CHECK, model="resnet20",
                 comm_round=3, frequency_of_the_test=3)
#: BASELINE config 1 (tests/test_baseline_configs.py:21-27) on its data's
#: full size: FedAvg logistic regression on the 60k/10k MNIST stand-in, SP,
#: 10 clients all in every round, 4 rounds
SP_CONFIG1 = dict(
    dataset="mnist", model="lr", training_type="simulation", backend="sp",
    partition_method="hetero", partition_alpha=0.5, client_num_in_total=10,
    client_num_per_round=10, comm_round=4, epochs=1, batch_size=16,
    learning_rate=0.1, frequency_of_the_test=1, enable_tracking=False,
    compute_dtype="float32", data_scale=10, random_seed=0,
    data_cache_dir=os.path.join(ROOT, ".data_cache", "chip_smoke_mnist"))
#: config 3's FedProx arm on SP at phase 9's width, 2 rounds, an eval each
SP_CONFIG3 = dict(LM_CONFIG, backend="sp", federated_optimizer="FedProx",
                  fedprox_mu=0.1, comm_round=2)


def _state_mb(api):
    """The arm's server state on the card, in MB, by name."""
    return {name: sum(t.numel() * t.element_size() for t in g.values()) / 1e6
            for name, g in api.server_state.items() if name != "opt_state"}


def arms_per_round(main_data):
    """Phase 18 (a): each arm on the north-star config, per round."""
    total = 0
    for arm, kw in ARMS:
        run = _drive(dict(MAIN_CONFIG, federated_optimizer=arm,
                          comm_round=ARM_ROUNDS, **kw),
                     rounds=ARM_ROUNDS, dataset=main_data)
        api, launches, final = run["api"], run["launches"], run["final"]
        groups = len(api.global_vars)
        want = ARM_ROUNDS * ARM_REDUCES[arm] * groups
        check(launches["weighted_reduce"] == want
              and launches["fused_epilogue"] == 0,
              f"{arm}: {ARM_ROUNDS} rounds over {groups} dtype group(s) "
              f"launched {launches}; want weighted_reduce {want}")
        total += launches["weighted_reduce"]
        state = _state_mb(api)
        phase(18, "main path", f"Parrot {arm} "
              + "".join(f"{k} {v} " for k, v in kw.items())
              + f"{api.args.model} {api.args.compute_dtype}, {api.n_total} "
              f"clients, {api.k} per round in {api.n_buckets} strata, "
              f"{ARM_ROUNDS} rounds: {ARM_ROUNDS / run['secs']:.3f} rounds/s "
              f"({run['steady']:.3f} after round 0), "
              f"{run['samples'] / run['secs']:.1f} samples/s; evals at "
              f"rounds {[m['round'] for m in api.metrics_history]}, final "
              f"test_acc {final['test_acc']:.4f} test_loss "
              f"{final['test_loss']:.4f}; weighted_reduce "
              f"{launches['weighted_reduce']} (the arm implies "
              f"{ARM_REDUCES[arm]} a round per dtype group: {want}); server "
              f"state "
              + (", ".join(f"{k} {v:.1f} MB" for k, v in state.items())
                 or "none")
              + f"; peak memory {run['peak'] / 2**30:.2f} GiB; data "
              f"{run['t_data']:.1f} s, whole drive {run['total']:.1f} s")
        run = api = None
    return total


def _replay_rate(api, n):
    """Rounds/s over ``n`` further replayed rounds, ended by reading their
    losses."""
    t0 = time.perf_counter()
    rows = api._fused_chunk(n).cpu()
    secs = time.perf_counter() - t0
    check(api._last_replays == n and bool(torch.isfinite(rows).all()),
          f"{api._last_replays} replays, metrics {rows}")
    return n / secs


def arms_fused(main_data):
    """Phase 18 (b): SCAFFOLD fused at full width, the other arms fused on
    ResNet-20."""
    total = 0
    run = _drive(dict(FUSED_CONFIG, federated_optimizer="SCAFFOLD",
                      comm_round=4, frequency_of_the_test=4),
                 rounds=4, dataset=main_data)
    api, launches = run["api"], run["launches"]
    stats = api.fused_stats
    _fused_chunk_checks(api, 4, 4)
    groups = len(api.global_vars)
    n_nodes, kinds, names, _ = _graph_summary(api)
    reduce = sum("weighted_reduce_kernel" in n for n in names)
    want = ARM_REDUCES["SCAFFOLD"] * groups
    check(reduce == want and launches["weighted_reduce"] == 2 * want,
          f"the captured SCAFFOLD round holds {reduce} weighted-reduce "
          f"nodes, not {want}; launches outside replays {launches}")
    total += launches["weighted_reduce"]
    table = api.server_state["c_locals"][torch.float32]
    before = table.clone()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        rows = api._fused_chunk(1)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    t_replay = time.perf_counter() - t0
    check(api._last_replays == 1 and bool(torch.isfinite(rows).all()),
          f"the SCAFFOLD replay: {api._last_replays} replays, {rows}")
    ids = sorted(api.round_ids.cpu().tolist())
    changed = (table != before).any(dim=1).nonzero().flatten().tolist()
    check(changed == ids, f"a replayed SCAFFOLD round changed the c_locals "
          f"rows {changed}, its clients were {ids}")
    before = None
    rate = _replay_rate(api, 3)
    final = run["final"]
    phase(18, "fused", f"SCAFFOLD fused rounds, {api.args.model} "
          f"{api.args.compute_dtype}, {api.n_total} clients, {api.k} per "
          f"round in {api.n_buckets} strata, 4 rounds in one chunk (round 1 "
          f"uncaptured, one capture, {stats['chunks'][0]['replays']} "
          f"replays): capture {stats['capture_s']:.2f} s, instantiate "
          f"{stats['instantiate_s']:.2f} s; the round's graph {n_nodes} "
          f"nodes ({kinds}), {reduce} weighted_reduce; a further replayed "
          f"round under sync-debug 'error' raised nothing "
          f"({t_replay:.2f} s) and changed the c_locals rows of exactly its "
          f"{len(ids)} clients {ids}; {rate:.3f} rounds/s over 3 more "
          f"replays (host clock, ended by reading their losses) against "
          f"phase 18's per-round path; final test_acc "
          f"{final['test_acc']:.4f}; server state "
          + ", ".join(f"{k} {v:.1f} MB" for k, v in _state_mb(api).items())
          + f"; peak memory {run['peak'] / 2**30:.2f} GiB; whole drive "
          f"{run['total']:.1f} s")
    run = api = table = None
    for arm, kw in ARMS:
        if arm == "SCAFFOLD":
            continue
        run = _drive(dict(ARM_FUSED, federated_optimizer=arm, **kw),
                     rounds=ARM_FUSED["comm_round"], dataset=main_data)
        api, launches = run["api"], run["launches"]
        _fused_chunk_checks(api, ARM_FUSED["comm_round"],
                            ARM_FUSED["frequency_of_the_test"])
        groups = len(api.global_vars)
        n_nodes, kinds, names, _ = _graph_summary(api)
        reduce = sum("weighted_reduce_kernel" in n for n in names)
        want = ARM_REDUCES[arm] * groups
        check(reduce == want and launches["weighted_reduce"] == 2 * want
              and launches["fused_epilogue"] == 0,
              f"the captured {arm} round holds {reduce} weighted-reduce "
              f"nodes, not {want}; launches outside replays {launches}")
        total += launches["weighted_reduce"]
        rate = _replay_rate(api, 2)
        stats = api.fused_stats
        phase(18, "fused", f"{arm} fused rounds, {api.args.model} "
              f"{api.args.compute_dtype}, {api.k} clients a round in "
              f"{api.n_buckets} strata capped at {api.bucket_cap}, "
              f"{ARM_FUSED['comm_round']} rounds in one chunk (round 1 "
              f"uncaptured, a capture, {stats['chunks'][0]['replays']} "
              f"replays): capture {stats['capture_s']:.2f} s, instantiate "
              f"{stats['instantiate_s']:.2f} s; the round's graph {n_nodes} "
              f"nodes ({kinds}), {reduce} weighted_reduce; {rate:.3f} "
              f"rounds/s over 2 more replays; final test_acc "
              f"{run['final']['test_acc']:.4f}; peak memory "
              f"{run['peak'] / 2**30:.2f} GiB; whole drive "
              f"{run['total']:.1f} s")
        run = api = None
    return total


def arms_sp(lm_data):
    """Phase 18 (c): BASELINE config 1 and config 3's FedProx arm on the SP
    backend."""
    run = _drive(SP_CONFIG1, rounds=SP_CONFIG1["comm_round"])
    api, launches, final = run["api"], run["launches"], run["final"]
    rounds = SP_CONFIG1["comm_round"]
    check(type(api).__name__ == "FedSimAPI"
          and launches["weighted_reduce"] == rounds
          and launches["fused_epilogue"] == 0,
          f"SP config 1 ran {type(api).__name__} and launched {launches}")
    check(final["test_acc"] > 0.5, f"SP config 1 test_acc {final}")
    reduces = launches["weighted_reduce"]
    phase(18, "SP", f"BASELINE config 1: SP FedAvg {api.args.model} on "
          f"{api.args.dataset} ({api.train_num} train / {api.test_num} test),"
          f" {api.args.client_num_in_total} clients all in every round, "
          f"{rounds} rounds: {rounds / run['secs']:.3f} rounds/s "
          f"({run['steady']:.3f} after round 0), {run['samples'] / run['secs']:.1f}"
          f" samples/s, test_acc by round "
          + ", ".join(f"{m['test_acc']:.4f}" for m in api.metrics_history)
          + f"; weighted_reduce {reduces} (1 a round); peak memory "
          f"{run['peak'] / 2**30:.3f} GiB; data {run['t_data']:.1f} s, whole "
          f"drive {run['total']:.1f} s")
    run = api = None
    run = _drive(SP_CONFIG3, unit="tokens", rounds=SP_CONFIG3["comm_round"],
                 dataset=lm_data)
    api, launches, final = run["api"], run["launches"], run["final"]
    rounds = SP_CONFIG3["comm_round"]
    evals = len(api.metrics_history)
    bs = int(api.args.batch_size)
    want_flash = 2 * (-(-int(api.test_num) // bs)) * evals
    check(type(api).__name__ == "FedSimAPI" and evals == rounds
          and launches["flash_attention"] == want_flash
          and launches["weighted_reduce"] == rounds
          and launches["fused_epilogue"] == 0,
          f"SP config 3 FedProx: {evals} evals, launches {launches}; want "
          f"flash_attention {want_flash}, weighted_reduce {rounds}")
    reduces += launches["weighted_reduce"]
    phase(18, "SP", f"BASELINE config 3, FedProx arm (mu "
          f"{api.args.fedprox_mu}) on SP: {api.args.model} "
          f"{api.args.compute_dtype} dropout {api.bundle.module.dropout} on "
          f"{api.args.dataset}, {api.args.client_num_in_total} clients, "
          f"{api.args.client_num_per_round} per round, {rounds} rounds: "
          f"{rounds / run['secs']:.3f} rounds/s, "
          f"{run['samples'] / run['secs']:.1f} train tokens/s; token "
          f"test_acc by round "
          + ", ".join(f"{m['test_acc']:.4f}" for m in api.metrics_history)
          + f"; flash_attention {launches['flash_attention']} in the "
          f"{evals} evals (2 per eval batch), weighted_reduce "
          f"{launches['weighted_reduce']}; peak memory "
          f"{run['peak'] / 2**30:.2f} GiB; whole drive {run['total']:.1f} s")
    return reduces, launches["flash_attention"]


def arms_phase(main_data, lm_data):
    """Phase 18: the other federated optimizers, per round, fused and on
    SP; returns its weighted-reduce and flash launches."""
    t0 = time.perf_counter()
    reduces = arms_per_round(main_data)
    reduces += arms_fused(main_data)
    sp_reduces, flash = arms_sp(lm_data)
    phase(18, "card", f"{_smi_line()}; phase 18 "
          f"{time.perf_counter() - t0:.1f} s")
    return {"weighted_reduce": reduces + sp_reduces,
            "flash_attention": flash}


def main():
    name, _ = device_phase()
    # the port's device choice: the card, with TF32 off
    dev = fedml_tpu_torch.device.get_device(
        fedml_tpu_torch.Config(device_type="cuda"))
    build_phase()
    p_main, d_main, errs, fold_launches = kernel_phase(dev)
    errs["flash_attention"] = flash_kernel_phase(dev)
    errs.update(wire_kernel_phase(dev))
    errs["fold_delta"] = fold_kernel_phase(dev)
    errs.update(mc_kernel_phase(dev))
    errs.update(po_kernel_phase(dev))
    timing = timing_phase(dev, p_main, d_main, name)
    timing["flash_attention"] = flash_timing_phase(dev, name)
    wire_timing, codec_round_s = wire_timing_phase(dev, name)
    timing.update(wire_timing)
    timing["fold_delta"] = fold_timing_phase(dev, name)
    timing.update(mc_timing_phase(dev, name))
    timing.update(po_timing_phase(dev, name))
    parity = parity_phase(dev)
    lm_parity_phase(dev)
    cs_parity_phase(dev)
    fed_llm_parity_phase(dev)
    # each main path's API is dropped before the next run, so that one's
    # peak memory is its own
    avg_launches = main_path_phase(6, "FedAvg")[0]
    opt_launches, api, main_data = main_path_phase(7, "FedOpt (server adam)",
                                                   **FEDOPT)
    trace_resnet(api)
    api = None
    lm_launches, api, lm_data = lm_main_path_phase(9)
    trace_lm(api)
    api = None
    cs_launches = cross_silo_phase(11, codec_round_s)
    llm_launches, last = fed_llm_phase(12)
    trace_fed_llm(last)
    last = None
    mc_launches = mc_main_path_phase(14, name, dev)
    po_launches = po_main_path_phase(15, dev)
    fused_avg, fused_opt = fused_phase(name, main_data)
    lm_fused, yogi_fused = lm_fused_phase(lm_data, main_data)
    arms = arms_phase(main_data, lm_data)
    main_data = lm_data = None
    # launches, each from its own path: the weighted reduce from the
    # ResNet main paths (phase 17's yogi drive and phase 18's arms too, per
    # round, fused and on SP), adam from the FedOpt
    # main paths (phase 17's config 3 too), momentum and sgd
    # from their card rounds in phase 5, mix from the async fold in phase
    # 3, the flash forward from the BERT-tiny paths' eval passes (Parrot
    # and, in phase 18, SP), the wire
    # kernels from the int8 cross-silo path, the fold from the fed-LLM path,
    # the conv kernels from the multi-client conv pass, the pallas_ops
    # kernels from their paths in phase 15
    launches = {
        **po_launches,
        "mc_conv.fwd": mc_launches["mc_conv.fwd"],
        "mc_conv.wgrad": mc_launches["mc_conv.wgrad"],
        "fold_delta": llm_launches["fold_delta"],
        "wire_compression.quantize": cs_launches["wire_compression.quantize"],
        "wire_compression.dequantize":
            cs_launches["wire_compression.dequantize"],
        "flash_attention": (lm_launches["flash_attention"]
                            + lm_fused["flash_attention"]
                            + arms["flash_attention"]),
        "weighted_reduce": (avg_launches["weighted_reduce"]
                            + opt_launches["weighted_reduce"]
                            + fused_avg["weighted_reduce"]
                            + fused_opt["weighted_reduce"]
                            + yogi_fused["weighted_reduce"]
                            + arms["weighted_reduce"]),
        "adam": (opt_launches["fused_epilogue.adam"]
                 + lm_launches["fused_epilogue.adam"]
                 + fused_opt["fused_epilogue.adam"]
                 + lm_fused["fused_epilogue.adam"]),
        "momentum": parity["FedOpt sgd momentum 0.9"][
            "fused_epilogue.momentum"],
        "sgd": parity["FedOpt sgd"]["fused_epilogue.sgd"],
        "none": fold_launches["fused_epilogue.none"],
    }
    rows = []
    for kname, source, replaces, channel in KERNELS:
        key = channel or kname
        check(launches[key] > 0, f"{kname}: no launch on its path")
        rows.append(dict(name=kname, route="cuda", source=source,
                         replaces=replaces, launches=launches[key],
                         max_abs_err=errs[key], **timing[key]))
    print(phase_walls(), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
