#!/usr/bin/env python3
"""The streaming kernels of the cross-silo wire, SecAgg, the server step
and the weighted average on one NVIDIA card: the wire quantize (kernel 10,
``fedml_tpu_torch/csrc/wire_compression.cu``) in each launch form and with
other rows a block as builds, the SecAgg quantize-mask (kernel 8,
``csrc/pallas_ops.cu``), kernels 1-5
(``csrc/weighted_reduce.cu``, ``csrc/fused_epilogue.cu``) at the FedOpt
round's columns beside their library yardsticks, and the weighted average
(kernel 7, ``csrc/pallas_ops.cu``) flat at four row alignments and over a
stacked ResNet-56 tree, with an empty launch; given an earlier checkout,
its builds of kernels 10, 8 and 7 in the same turns and its phase-4 lines;
and, on request, kernels 8, 10 and 11 again behind a cache flush that
leaves L2 clean.

Run from the root of a checkout:

    python3 profile_streaming.py [--qrows N ...] [--parent DIR] [--clean-l2]
                                 [--only SECTION ...]

Every time is the device time of one call on a cold L2 (a 256 MB write
before each), the host hidden behind a GPU sleep, median of 50, each probe
timed in turns (the list, then the list reversed).  Every output is held
bit for bit to its plain version before it is timed.

* Kernel 10 at ResNet-56's 860,026 values (``chip_smoke._wire_vector``'s
  rows): one segment (the uplink) through the port (the flat form) and
  through a one-row device table; the broadcast's 287 segments through the
  port (by value) and through the 287-row device table; 2,100 one-to-three
  value segments past the by-value capacity (the table form).  Each
  ``--qrows N`` build (``wire_compression.cu`` with N rows, a warp each, a
  block) in the flat, by-value and table forms.
* Kernel 8 at 860,026 float32 values and random masks: the port and the
  plain version.
* Kernels 1-5 on a ``[10, 860,032]`` float32 buffer at the FedOpt round's
  parameter columns ``[0, 855,776)`` (kernel 1 on all columns), s = 1,
  with ``torch.matmul(wn, x)`` beside kernel 1 and ``torch.addmv`` beside
  mix and sgd; kernels 2-5 read the step's row from the device table as
  the per-round path launches them (the step by value), and adam also as
  the fused rounds launch it (its count on the device, advanced by an
  add).
* Kernel 7 flat at ``[10, D]`` float32 with int32 weights for D 860,025,
  860,026 (ResNet-56), 860,027 and 860,032, beside
  ``torch.matmul(wn[None], x)``; and the whole ``agg_stacked_pallas`` call
  over ``chip_smoke.resnet56_stacked``'s tree (287 leaves) in its own form
  and through the device table, against the leaves concatenated first and
  the flat kernel (``chip_smoke.agg_by_concatenation``).  The registers
  nvcc gave each of its kernels are printed first.

``--only`` times the named sections alone: ``quantize`` (kernel 10),
``qmask`` (8), ``server`` (1-5), ``wavg`` (7), ``phase4`` (the phase-4
turns of ``--parent``).  Each ``--wavg-set NAME=N[,NAME=N]`` build
(``pallas_ops.cu`` with those constants of the weighted average set:
``kShiftRows`` and ``kWavgRows``, the client rows a lane has in flight
where rows sit anywhere against the 16-byte chunks and where they sit on
one or halfway; ``kWavgPrefetch``, 0 or 1) is timed flat and over the
tree by value beside the port.

With ``--parent DIR`` (a checkout of an earlier commit) its
``wire_compression.cu`` and ``pallas_ops.cu`` are built too and timed in
the same turns (its quantize takes the device table in every form, its
quantize-mask and its flat weighted average their own launches, the
latter also behind the concatenation), and ``chip_smoke``'s phase-4
timings of every row of that checkout and of this one run in
subprocesses in turns (parent, new, new, parent), both with the host
hidden.  Every line of numbers starts with the card's name and power limit
as ``nvidia-smi`` reports them; the last line is one JSON object of all of
it.  With ``--clean-l2`` the flush before each call reads its 256 MB
instead of writing them: L2 then holds clean lines, and a kernel's misses
evict nothing that must first go back to device memory (after the usual
flush every line a kernel brings in displaces a dirty one).  It needs one
CUDA card and ``nvcc``; without a card it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

import chip_smoke
import fedml_tpu_torch
from fedml_tpu_torch.ops import cuda_build
from fedml_tpu_torch.ops import epilogue
from fedml_tpu_torch.ops import pallas_ops as po
from fedml_tpu_torch.ops import wire_compression as wc
from fedml_tpu_torch.utils.tree import tree_leaves

WIRE_FNS = ("fedml_quantize_int8", "fedml_quantize_int8_flat",
            "fedml_quantize_int8_rows", "fedml_wire_block",
            "fedml_cuda_error_string")
QMASK_FNS = ("fedml_quantize_mask", "fedml_weighted_average",
             "fedml_cuda_error_string")
QROWS = re.compile(r"constexpr int kQRows = \d+;")
WAVG_FNS = ("fedml_weighted_average", "fedml_weighted_average_leaves",
            "fedml_weighted_average_table", "fedml_cuda_error_string")
PAST = [1 + i % 3 for i in range(2100)]
#: kernel 7's flat widths: ResNet-56's variables (D = 2 mod 4), its
#: neighbours (1 and 3 mod 4) and the next multiple of 4
WAVG_DS = (860025, 860026, 860027, 860032)
SECTIONS = ("quantize", "qmask", "server", "wavg", "phase4")

#: runs one checkout's phase-4 timings of every row in its own process,
#: the host hidden for every call
PHASE = """
import chip_smoke, fedml_tpu_torch
_time = chip_smoke._time_ms
chip_smoke._time_ms = lambda fn, flush, **kw: _time(fn, flush,
                                                   **dict(kw, hide=True))
name, _ = chip_smoke.device_phase()
dev = fedml_tpu_torch.device.get_device(
    fedml_tpu_torch.Config(device_type="cuda"))
p_main, d_main = chip_smoke.main_layout()
chip_smoke.timing_phase(dev, p_main, d_main, name)
chip_smoke.flash_timing_phase(dev, name)
chip_smoke.wire_timing_phase(dev, name)
chip_smoke.fold_timing_phase(dev, name)
chip_smoke.mc_timing_phase(dev, name)
chip_smoke.po_timing_phase(dev, name)
"""


def say(card, text):
    print(f"{card} | {text}", flush=True)


def turns(probes, flush):
    """Each probe's device time, in turns: the list, then reversed."""
    order = list(probes) + list(reversed(probes))
    times = {n: [] for n in probes}
    for n in order:
        times[n].append(chip_smoke._time_ms(
            probes[n], flush, **chip_smoke._hidden(probes[n])))
    return times


def report(card, what, times, bound_ms=None):
    for n, ts in times.items():
        med = statistics.median(ts)
        share = (f", {bound_ms / med:.1%} of the bound {bound_ms:.5f}"
                 if bound_ms and n != "empty launch" else "")
        say(card, f"{what}: {n} {' / '.join(f'{t:.4f}' for t in ts)} ms "
            f"(median {med:.4f}){share}")


def variant(name, src_text, constants, like, fns):
    """A copy of a kernel source with build constants set (pattern ->
    value), built and bound like the port's library."""
    text = src_text
    for pattern, value in constants.items():
        text, hits = pattern.subn(
            pattern.pattern.replace(r"\d+", str(value)), text)
        if hits != 1:
            raise RuntimeError(f"{name}: {pattern.pattern} not found once")
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = cuda_build.BUILD_DIR / f"{name}.cu"
    path.write_text(text)
    return cuda_build.load_variant(name, str(path), like, fns)


class CleanFlush:
    """Stands in for ``chip_smoke._time_ms``'s flush buffer: its ``zero_``
    reads the 256 MB instead of writing them, so L2 holds clean lines."""

    def __init__(self, buf):
        self.buf = buf
        self.acc = torch.empty((), dtype=buf.dtype, device=buf.device)

    def zero_(self):
        torch.sum(self.buf, dim=0, out=self.acc)


def check_rc(rc, what):
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc}")


def wire_probes(libs, x, xp, lengths, dev, with_forms):
    """name -> a quantize through each build's C interface into fresh
    outputs: flat and by value where the build has them, the device table
    always; x one segment and the 287 leaves, xp the 2,100 segments."""
    dev_i, stream = dev.index or 0, torch.cuda.current_stream(dev).cuda_stream
    d = x.numel()
    rows = wc.n_blocks(d)
    start = wc.segments_by_value(lengths)
    t1 = wc._segment_table((d,), dev)
    t287 = wc._segment_table(tuple(lengths), dev)
    tpast = wc._segment_table(tuple(PAST), dev)

    def table(lib, v, t, label):
        def run():
            q = torch.empty(v.numel(), dtype=torch.int8, device=dev)
            s = torch.empty(t.rows, dtype=torch.float32, device=dev)
            check_rc(lib.fedml_quantize_int8(v.data_ptr(), t.table.data_ptr(),
                                             t.n_seg, t.rows, q.data_ptr(),
                                             s.data_ptr(), dev_i, stream),
                     label)
            return q, s
        return run

    probes = {}
    for label, lib in libs.items():
        if label in with_forms:
            def flat(lib=lib, label=label):
                q = torch.empty(d, dtype=torch.int8, device=dev)
                s = torch.empty(rows, dtype=torch.float32, device=dev)
                check_rc(lib.fedml_quantize_int8_flat(
                    x.data_ptr(), d, rows, q.data_ptr(), s.data_ptr(), dev_i,
                    stream), label)
                return q, s

            def by_value(lib=lib, label=label):
                q = torch.empty(d, dtype=torch.int8, device=dev)
                s = torch.empty(t287.rows, dtype=torch.float32, device=dev)
                check_rc(lib.fedml_quantize_int8_rows(
                    x.data_ptr(), start.ctypes.data, t287.rows, q.data_ptr(),
                    s.data_ptr(), dev_i, stream), label)
                return q, s

            probes[f"{label} flat (1 segment)"] = flat
            probes[f"{label} by value (287 segments)"] = by_value
        probes[f"{label} table (1 segment)"] = table(lib, x, t1, label)
        probes[f"{label} table (287 segments)"] = table(lib, x, t287, label)
        probes[f"{label} table (2100 segments)"] = table(lib, xp, tpast,
                                                         label)
    return probes


def qmask_probes(libs, x, m, dev):
    """name -> a quantize-mask through each build's C interface."""
    dev_i, stream = dev.index or 0, torch.cuda.current_stream(dev).cuda_stream
    probes = {}
    for label, lib in libs.items():
        def run(lib=lib, label=label):
            out = torch.empty_like(m)
            check_rc(lib.fedml_quantize_mask(x.data_ptr(), 0, m.data_ptr(),
                                             out.data_ptr(), float(po.SCALE),
                                             x.numel(), dev_i, stream),
                     label)
            return out
        probes[label] = run
    return probes


def wavg_section(name, card, flush, parent_lib, builds):
    """Kernel 7: the flat form at ``[10, D]`` float32 with int32 weights
    for each D of ``WAVG_DS`` (the port, the parent's build, the library
    call), and the tree call over ``chip_smoke``'s stacked 10-client
    ResNet-56 tree (the port's ``agg_stacked_pallas``, and the design that
    concatenates first, through the port's flat kernel and the parent's);
    every kernel output held to the port's bits or its plain version
    before it is timed."""
    dev = flush.device
    dev_i, stream = dev.index or 0, torch.cuda.current_stream(dev).cuda_stream
    gen = torch.Generator(device=dev).manual_seed(16)
    c = 10
    probes, bounds, result = {}, {}, {"forms": {}}

    def flat_through(lib, x, w):
        out = torch.empty(x.shape[1], dtype=torch.float32, device=dev)
        check_rc(lib.fedml_weighted_average(
            x.data_ptr(), 0, w.data_ptr(), po._W_CODES[w.dtype],
            out.data_ptr(), x.shape[0], x.shape[1], dev_i, stream),
            "weighted_average")
        return out

    def parent_flat(x, w):
        return flat_through(parent_lib, x, w)

    for d in WAVG_DS:
        x = torch.randn(c, d, generator=gen, device=dev)
        w = torch.randint(100, 900, (c,), generator=gen, device=dev,
                          dtype=torch.int32)
        wn = po.normalized_weights(w)
        got = po.weighted_average_flat(x, w)
        torch.cuda.synchronize()
        chip_smoke._order_err(got, po.weighted_average_flat_reference(x, w),
                              wn.abs() @ x.abs(), c, f"flat D {d}")
        probes[f"port flat D {d}"] = (
            lambda x=x, w=w: po.weighted_average_flat(x, w))
        probes[f"matmul(wn[None], x) D {d}"] = (
            lambda x=x, wn=wn: torch.matmul(wn[None], x))
        if parent_lib is not None:
            chip_smoke.check(torch.equal(parent_flat(x, w), got),
                             f"flat D {d}: the parent's bits differ")
            probes[f"parent flat D {d}"] = (
                lambda x=x, w=w: parent_flat(x, w))
        for label, lib in builds.items():
            chip_smoke.check(torch.equal(flat_through(lib, x, w), got),
                             f"flat D {d}: the {label} build's bits differ")
            probes[f"{label} flat D {d}"] = (
                lambda x=x, w=w, lib=lib: flat_through(lib, x, w))
        bounds[f"D {d}"] = chip_smoke._bound((c + 1) * d * 4 + c * 4,
                                             2 * c * d, name)[0]

    stacked, counts = chip_smoke.resnet56_stacked(
        dev, torch.Generator(device=dev).manual_seed(18))
    leaves = tree_leaves(stacked)
    d = sum(leaf[0].numel() for leaf in leaves)
    flat = torch.cat([leaf.reshape(c, -1).float() for leaf in leaves], 1)
    want = po.weighted_average_flat(flat, counts)
    got = torch.cat([v.reshape(-1) for v in
                     tree_leaves(po.agg_stacked_pallas(stacked, counts))])
    torch.cuda.synchronize()
    chip_smoke.check(torch.equal(got, want), "tree call: bits differ from "
                     "the flat form over the concatenation")
    del flat
    # the same tree through the device table, the form past the by-value
    # capacity
    sizes = [leaf[0].numel() for leaf in leaves]
    ends = np.cumsum(sizes)
    tiles = -(-d // 128)
    straddle = sum(1 for t in range(tiles) if np.searchsorted(
        ends, 128 * t, "right") != np.searchsorted(
            ends, min(128 * t + 128, d) - 1, "right"))
    say(card, f"tree: {len(leaves)} leaves, {d} values; {straddle} of "
        f"{tiles} 128-column tiles hold columns of more than one leaf")
    result["straddling_tiles"] = straddle
    result["forms"]["tree"] = po.weighted_average_form(sizes)
    plan = po.weighted_average_plan(sizes)._replace(form="table")
    w_code = po._W_CODES[counts.dtype]

    def table():
        out = torch.empty(d, dtype=torch.float32, device=dev)
        po._launch_leaves(plan, leaves, counts, w_code, out)
        return out

    chip_smoke.check(torch.equal(table(), want), "tree call through the "
                     "device table: bits differ from the flat form")
    probes[f"port tree call ({result['forms']['tree']})"] = (
        lambda: po.agg_stacked_pallas(stacked, counts))
    probes["port tree, device table"] = table
    by_value = plan._replace(form="by_value")
    for label, lib in builds.items():
        def tree_through(lib=lib):
            out = torch.empty(d, dtype=torch.float32, device=dev)
            po._launch_leaves(by_value, leaves, counts, w_code, out, lib)
            return out

        chip_smoke.check(torch.equal(tree_through(), want),
                         f"tree through the {label} build: bits differ")
        probes[f"{label} tree, by value"] = tree_through
    probes["concatenation + port flat"] = (
        lambda: chip_smoke.agg_by_concatenation(stacked, counts))
    if parent_lib is not None:
        probes["concatenation + parent flat"] = (
            lambda: chip_smoke.agg_by_concatenation(
                stacked, counts, lambda x, w: parent_flat(x, w)))
    bounds["tree"] = chip_smoke._bound((c + 1) * d * 4 + c * 8, 2 * c * d,
                                       name)[0]
    chip_smoke._time_ms(probes["port tree, device table"], flush)  # clocks
    times = turns({"empty launch": lambda: torch.cuda._sleep(0), **probes},
                  flush)
    result.update(ms=times, bound_ms=bounds, leaves=len(leaves), d=d)
    for n, ts in times.items():
        key = next((k for k in bounds if n.endswith(k)), "tree")
        b = None if n == "empty launch" else bounds[key]
        share = (f", {b / statistics.median(ts):.1%} of the bound {b:.4f}"
                 if b else "")
        say(card, f"weighted average (flat [10, D] f32 int32 weights; tree: "
            f"{len(leaves)} leaves, {d} values, int64 weights): {n} "
            f"{' / '.join(f'{t:.4f}' for t in ts)} ms (median "
            f"{statistics.median(ts):.4f}){share}")
    return result


def parent_turns(parent, card):
    """The phase-4 lines of rows 1-5, 7, 8 and 10 from ``parent`` and from
    this checkout, in subprocesses, in turns."""
    here = os.path.dirname(os.path.abspath(__file__))
    out = []
    for label, root in (("parent", parent), ("new", here), ("new", here),
                        ("parent", parent)):
        proc = subprocess.run([sys.executable, "-c", PHASE], cwd=root,
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"phase 4 in {root} failed:\n"
                               f"{proc.stdout[-4000:]}{proc.stderr[-4000:]}")
        lines = [x.strip() for x in proc.stdout.splitlines()
                 if x.startswith("[4/")]
        for line in lines:
            say(card, f"{label}: {line}")
        out.append((label, lines))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--qrows", action="append", default=[], type=int,
                    metavar="N", help="a wire_compression.cu build whose "
                                      "quantize takes N rows a block")
    ap.add_argument("--parent", metavar="DIR",
                    help="a checkout whose kernels 10 and 8 to time in the "
                         "same turns, and whose phase-4 timings to run in "
                         "turns with this one's")
    ap.add_argument("--clean-l2", action="store_true",
                    help="also time kernels 8, 10 and 11 behind a flush "
                         "that leaves L2 clean")
    ap.add_argument("--wavg-set", action="append", default=[],
                    metavar="NAME=N[,NAME=N]",
                    help="a pallas_ops.cu build with these integer "
                         "constants of the weighted average set (kShiftRows, "
                         "kWavgRows, kWavgPrefetch)")
    ap.add_argument("--only", action="append", choices=SECTIONS,
                    metavar="SECTION",
                    help="time only these sections (repeatable): "
                         "quantize (kernel 10), qmask (8), server (1-5), "
                         "wavg (7), phase4 (the phase-4 turns with "
                         "--parent); by default all")
    args = ap.parse_args()
    only = set(args.only or SECTIONS)
    if args.clean_l2 and not {"quantize", "qmask"} <= only:
        ap.error("--clean-l2 times kernels 10 and 8 again: it needs the "
                 "quantize and qmask sections")
    name, smi = chip_smoke.device_phase()
    dev = fedml_tpu_torch.device.get_device(
        fedml_tpu_torch.Config(device_type="cuda"))
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    result = {"card": smi}
    empty = {"empty launch": lambda: torch.cuda._sleep(0)}

    # the builds, one nvcc each, all started together
    cuda_build.build_all(["weighted_reduce", "fused_epilogue",
                          "wire_compression", "pallas_ops"])
    wlib, plib = wc._kernel_lib(), po._kernel_lib()
    wsrc = (cuda_build.CSRC / "wire_compression.cu").read_text()
    with ThreadPoolExecutor(max_workers=8) as pool:
        wfut = {f"qrows {n}": pool.submit(
            variant, f"wire_compression_qrows{n}", wsrc, {QROWS: n}, wlib,
            WIRE_FNS) for n in args.qrows}
        pfut = {}
        if args.parent:
            csrc = Path(args.parent) / "fedml_tpu_torch" / "csrc"
            wfut["parent"] = pool.submit(
                cuda_build.load_variant, "wire_compression_parent",
                str(csrc / "wire_compression.cu"), wlib,
                ("fedml_quantize_int8", "fedml_cuda_error_string"))
            pfut["parent"] = pool.submit(
                cuda_build.load_variant, "pallas_ops_parent",
                str(csrc / "pallas_ops.cu"), plib, QMASK_FNS)
        psrc = (cuda_build.CSRC / "pallas_ops.cu").read_text()
        for i, spec in enumerate(args.wavg_set):
            consts = {re.compile(rf"constexpr int {k} = \d+;"): int(v)
                      for k, v in (kv.split("=") for kv in spec.split(","))}
            pfut[f"set {spec}"] = pool.submit(
                variant, f"pallas_ops_set{i}", psrc, consts, plib, WAVG_FNS)
        wlibs = {"new": wlib, **{k: f.result() for k, f in wfut.items()}}
        plibs = {k: f.result() for k, f in pfut.items()}
    kq = int(re.search(r"\d+", QROWS.search(wsrc).group()).group())
    for build, log in sorted(cuda_build.build_logs.items()):
        if not build.startswith("pallas_ops"):
            continue
        log = log.splitlines()
        for i, line in enumerate(log):
            if "Compiling entry" in line and "wavg" in line:
                used = next((x for x in log[i + 1:i + 4] if "Used" in x), "")
                say(smi, f"{build} {line.split(chr(39))[1][-50:]}: "
                    f"{used.strip()[11:]}")
    say(smi, f"builds: the quantize's {kq} rows a block (new); others "
        f"{sorted(wlibs)}, "
        f"quantize-mask {sorted(plibs)}")

    lengths = chip_smoke.resnet56_wire_lengths()
    d = sum(lengths)
    if "quantize" in only:  # kernel 10
        gen = torch.Generator().manual_seed(6)
        x = chip_smoke._wire_vector(d, gen).to(dev)
        xp = chip_smoke._wire_vector(sum(PAST), gen).to(dev)
        want = {"1": wc.quantize_int8_blocked(x.cpu()),
                "287": wc.quantize_int8_blocked(x.cpu(), lengths),
                "2100": wc.quantize_int8_blocked(xp.cpu(), PAST)}
        probes = wire_probes(wlibs, x, xp, lengths, dev,
                             [k for k in wlibs if k != "parent"])
        probes["port one segment"] = lambda: wc.quantize_int8_blocked(x)
        probes["port 287 segments"] = lambda: wc.quantize_int8_blocked(x,
                                                                       lengths)
        probes["port 2100 segments"] = lambda: wc.quantize_int8_blocked(xp, PAST)
        for label, fn in probes.items():
            key = re.search(r"(\d+) segment", label) or None
            got = fn()
            torch.cuda.synchronize()
            ref = want[key.group(1) if key else "1"]
            chip_smoke._same_bits(got[0].cpu(), ref[0], f"quantize {label} q")
            chip_smoke._same_bits(got[1].cpu(), ref[1],
                                  f"quantize {label} scales")
        chip_smoke._time_ms(probes["port one segment"], flush)    # clocks up
        times = turns({**empty, **probes}, flush)
        rows = wc.n_blocks(d)
        bound_ms, _ = chip_smoke._bound(4 * d + d + 4 * rows, 6 * d + 2 * rows,
                                        name)
        result["quantize"] = {"ms": times, "bound_ms": bound_ms,
                              "forms": {"1": wc.quantize_form([d]),
                                        "287": wc.quantize_form(lengths),
                                        "2100": wc.quantize_form(PAST)}}
        report(smi, f"quantize at D {d} (segments as named; bound for "
               f"D {d})", times, bound_ms)

    if "qmask" in only:  # kernel 8
        gq = torch.Generator(device=dev).manual_seed(16)
        xq = torch.randn(d, generator=gq, device=dev) * 0.01
        mq = torch.randint(-2 ** 31, 2 ** 31, (d,), generator=gq, device=dev,
                           dtype=torch.int32)
        probes = qmask_probes(plibs, xq, mq, dev)
        ref = po.quantize_mask_reference(xq, mq)
        for label, fn in probes.items():
            got = fn()
            torch.cuda.synchronize()
            chip_smoke.check(torch.equal(got, ref),
                             f"quantize_mask {label}: words differ")
        probes["port"] = lambda: po.quantize_mask(xq, mq)
        probes["plain"] = lambda: po.quantize_mask_reference(xq, mq)
        chip_smoke._time_ms(probes["port"], flush)
        times = turns({**empty, **probes}, flush)
        bound_ms, _ = chip_smoke._bound(12 * d, 3 * d, name)
        result["quantize_mask"] = {"ms": times, "bound_ms": bound_ms}
        report(smi, f"quantize_mask at D {d} f32", times, bound_ms)

    if "server" in only:  # kernels 1-5 at the FedOpt round's columns
        p_main, d_main = chip_smoke.main_layout()
        gen = torch.Generator().manual_seed(1)
        xs, w = chip_smoke._inputs(10, d_main, torch.float32, "pos", gen, dev)
        wn = w / torch.clamp(w.sum(), min=1e-12)
        cols = xs[:, :p_main]
        g = torch.randn(p_main, generator=gen).to(dev)
        res, lib_res = torch.empty_like(g), torch.empty_like(g)
        probes = {"weighted_reduce": lambda: epilogue.weighted_reduce(xs, w),
                  "matmul(wn, x)": lambda: torch.matmul(wn, xs)}
        bounds = {"weighted_reduce": chip_smoke._bound(
            10 * d_main * 4 + d_main * 4 + 40, 20 * d_main, name)[0]}
        for opt in chip_smoke.CHANNELS:
            spec = epilogue.EpilogueSpec(opt=opt, lr=1e-3)
            st = epilogue.init_opt_state(g, spec)
            if st is not None:
                st["m"].normal_()
                if "v" in st:
                    st["v"].uniform_()
                    st["t"] = 4
            label = f"fused_epilogue.{'mix' if opt == 'none' else opt}"
            steps = epilogue.step_rows(1.0, spec, 4096, dev)
            probes[label] = (
                lambda spec=spec, st=st, steps=steps: epilogue.fused_epilogue(
                    g, cols, w, 1.0, spec, st, out=res, steps=steps))
            if opt == "adam":
                st_dev = dict(st, t=torch.tensor(4, dtype=torch.int64,
                                                 device=dev))
                probes[f"{label} (t on the device, its add included)"] = (
                    lambda spec=spec, st=st_dev, steps=steps:
                    epilogue.fused_epilogue(g, cols, w, 1.0, spec, st,
                                            out=res, steps=steps))
            streams = {"none": 0, "sgd": 0, "momentum": 2, "adam": 4}[opt]
            bounds[label] = chip_smoke._bound(
                (10 + 2 + streams) * p_main * 4 + 40,
                (20 + chip_smoke.CHANNEL_OPS[opt]) * p_main, name)[0]
            if opt in ("none", "sgd"):
                a = 1.0 if opt == "none" else spec.lr
                probes[f"addmv for {opt}"] = (
                    lambda a=a: torch.addmv(g, cols.t(), wn, beta=1.0 - a,
                                            alpha=a, out=lib_res))
        times = turns({**empty, **probes}, flush)
        result["server_step"] = {"ms": times, "bound_ms": bounds}
        for n, ts in times.items():
            b = bounds.get(n)
            share = f", {b / statistics.median(ts):.1%} of the bound {b:.4f}" \
                if b else ""
            say(smi, f"server step at columns [0, {p_main}) of [10, {d_main}] "
                f"f32: {n} {' / '.join(f'{t:.4f}' for t in ts)} ms (median "
                f"{statistics.median(ts):.4f}){share}")

    if "wavg" in only:
        result["weighted_average"] = wavg_section(
            name, smi, flush, plibs.get("parent"),
            {k: v for k, v in plibs.items() if k.startswith("set ")})

    if args.clean_l2:
        # kernels 10, 11 and 8 and their parents' builds behind a flush
        # that leaves L2 clean
        q0, s0 = wc.quantize_int8_blocked(x)
        probes = {"quantize one segment": lambda: wc.quantize_int8_blocked(x),
                  "quantize 287 segments":
                      lambda: wc.quantize_int8_blocked(x, lengths),
                  "dequantize one segment":
                      lambda: wc.dequantize_int8_blocked(q0, s0, d),
                  "quantize_mask": lambda: po.quantize_mask(xq, mq)}
        if args.parent:
            wire = wire_probes({"parent": wlibs["parent"]}, x, xp, lengths,
                               dev, [])
            probes["parent quantize table (1 segment)"] = \
                wire["parent table (1 segment)"]
            probes["parent quantize table (287 segments)"] = \
                wire["parent table (287 segments)"]
            probes["parent quantize_mask"] = qmask_probes(
                {"parent": plibs["parent"]}, xq, mq, dev)["parent"]
        times = turns({**empty, **probes}, CleanFlush(flush))
        result["clean_l2"] = {"ms": times}
        report(smi, f"clean L2, D {d}", times)

    if args.parent and "phase4" in only:
        result["phase4_turns"] = parent_turns(args.parent, smi)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
