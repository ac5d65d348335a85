"""Parrot — federated simulation on one device.

Port of ``fedml_tpu/simulation/parrot/parrot_api.py``: ``bucket_plan``, the
FedAvg and FedOpt arms of ``build_aggregate``, ``ParrotAPI``'s per-round
path — the uniform round and the size-bucketed round — and its fused
multi-round path (``run_rounds_fused``, ``fused_rounds: true``).

A round of the per-round path:

* samples clients on the host;
* gathers each sampled client's padded batch grid from the device-resident
  dataset (the index arithmetic runs on the host, the gather on the device);
* trains the sampled clients one after another — the JAX package vmaps
  them, and with one client per stratum (the north-star config) a loop
  computes the same thing — each into row ``c`` of a stacked ``[C, D]``
  buffer per dtype (``FlatVariables``: parameters first, then the BatchNorm
  statistics);
* aggregates the stacked buffers, weighted by each client's full sample
  count (sequences, for a language model; its metrics count tokens): FedAvg
  reduces each with the weighted-reduce kernel, one launch
  per dtype; FedOpt runs the server step on the parameter columns with the
  fused-epilogue kernel and reduces the statistics columns with the
  weighted-reduce kernel, two launches per dtype (``build_aggregate``).
  The new global model is written into the global buffers, and the server
  state into its own tensors; the fused epilogue reads its step's row from
  a device table (``ops/epilogue.step_rows``).

The fused rounds (``run_rounds_fused``) run the same round with nothing
read on the host, in chunks of ``FUSED_CHUNK_ROUNDS`` rounds, the host
reading the chunk's losses once.  Clients and window starts are drawn on
the device; every batch of a client's grid runs, gated by its device flag
(``build_local_update(..., gated=True)``); the index matrices, strata,
weights and metrics stay on the device.  On a card each round is one replay
of a CUDA graph: the first round of a ``ParrotAPI`` runs uncaptured (it
builds the kernels and warms the libraries), then the round is captured
once, with its generators registered so that every replay draws anew; a
capture that fails raises.  On the CPU the same round body runs
uncaptured, which is how the tests hold it to the JAX package's scan.
Each call of ``run_rounds_fused(n, rng)`` reseeds the generators first, as
the JAX package takes a key per call; ``train()`` passes a fresh seed per
chunk.

With ``checkpoint_dir`` both paths save ``{round_idx, global_vars,
server_state}`` (``utils/checkpoint.RoundCheckpointer``, the JAX package's
file format) — the per-round path every ``checkpoint_frequency`` rounds
(10) and at the last, the fused rounds after each eval — and resume from
the newest save, written into the live buffers in place.

Deviations from the reference: the bucketed round draws its clients and its
window starts with a seeded ``torch.Generator`` (``seed + 17``), where the
JAX package draws them with ``jax.random``; the distribution is the same
(quota ``q`` per stratum without replacement, uniform window start mod the
client's size), the draws are not.  The fused rounds draw from a
``torch.Generator`` on the round's device seeded, per call, with the
call's seed (``seed + 23`` without ``rng``), where the JAX package splits
``PRNGKey(seed + 23)`` or the call's key: a uniform round takes the first
``k`` of a permutation of the ``n`` clients (the order of ``n`` random
62-bit keys), a stratum the first ``q`` of a permutation of its members,
plus a window start in ``[0, 2^30)`` per client where it is capped — the
same distributions as ``jax.random.permutation`` and ``randint``, other
bits.  The per-round path's uniform ``np.random.seed(round)`` draw is the
reference's, exactly.  Dropout draws, on the per-round path, from a host
generator seeded ``seed + 31``, one seed per training step
(``ml/engine/local_update.py``); in the fused rounds, from a second card
generator seeded with the call's seed + 8 (``seed + 31`` without ``rng``)
and registered with the graph, every batch drawing, padded or not; the JAX
package splits its round key per client and per step.

Token data (``fed_shakespeare``: ``x`` and ``y`` of ``[N, 80]`` tokens)
takes the same path: the device-resident dataset keeps ``x`` in the
bundle's integer input dtype, the gathers yield ``[nb, B, T]`` grids with
a ``[nb, B]`` sequence mask, and clients partition by their first label
token when no row map was stashed.

Not ported yet: the SCAFFOLD/FedDyn/FedNova/Mime/FedProx arms, robust
aggregation, the AOT cache and compile-ahead, mesh/remesh/resize and the
flight recorder.  The fused rounds run every option the per-round path
runs: the unfused adam's and yogi's step counts are device tensors there,
their bias corrections read from a device table.

To run the fused rounds, set ``fused_rounds: true`` in the config (with
``device_type: cpu`` on the CPU; the card by default): ``train()`` then runs
chunks of ``frequency_of_the_test`` rounds, an eval after each.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ...constants import FED_OPT_FEDAVG, FED_OPT_FEDOPT
from ...ml.aggregator.agg_operator import agg_stacked
from ...ml.engine.device import get_device
from ...ml.engine.local_update import (
    build_eval_step,
    build_local_update,
    make_batches,
)
from ...ml.engine.model_bundle import FlatVariables
from ...ml.engine.optimizers import (
    ServerOptimizer,
    apply_updates,
    build_server_optimizer,
)
from ...ops.cuda_graphs import graph_nodes
from ...ops.epilogue import (
    EpilogueSpec,
    StepRows,
    fused_epilogue,
    init_opt_state,
    spec_from_args,
    step_rows,
    weighted_reduce,
)
from ...utils.checkpoint import RoundCheckpointer
from ...utils.weights import from_flax_variables, to_flax_variables

#: offsets from ``random_seed`` of the rounds' draws: the bucketed per-round
#: path's host generator, the fused rounds' card generator (the JAX
#: package's ``PRNGKey(seed + 23)``), and dropout on both paths
BUCKET_SEED_OFFSET = 17
SAMPLE_SEED_OFFSET = 23
DROPOUT_SEED_OFFSET = 31


def bucket_plan(sizes: np.ndarray, k: int, bs: int, n_buckets: int,
                cap_ratio: float = 0.0) -> List[Dict[str, Any]]:
    """Pure size-bucket policy, the JAX package's verbatim (numpy only).

    Clients sort by size into ``B`` equal-count strata (B snapped to a
    divisor of ``k`` so quotas stay equal — every client's inclusion
    probability is exactly k/N).  Each stratum's batch capacity is

    * ``cap_ratio == 0``: ``nb = ceil(max_size_in_stratum / bs)`` — every
      sampled client runs its full local epoch (reference semantics), at
      the cost of padding every stratum to its LARGEST member.
    * ``cap_ratio > 0``:  ``nb = ceil(cap_ratio·mean_size / bs)`` (capped
      at the full capacity) — clients above the cap run a per-round
      ROTATING window of ``nb·bs`` of their samples instead of a full
      epoch, so padded compute tracks the stratum's mean, not its max.
      Coverage is preserved across rounds (the window start is uniform
      per round) and aggregation weights still use full sample counts.

    Returns one dict per stratum: ``members`` (client ids, size-sorted),
    ``q`` (clients sampled per round), ``nb`` (compute batch capacity),
    ``nb_full`` (capacity covering the largest member — the index-matrix
    width rotation addresses into), ``padded`` (q·nb·bs slots per round)
    and ``real`` (q·E[min(size, nb·bs)] expected real samples per round).
    """
    sizes = np.asarray(sizes)
    n_total = int(sizes.shape[0])
    divisors = [d for d in range(1, int(k) + 1)
                if int(k) % d == 0 and d <= n_total]
    b_eff = min(divisors, key=lambda d: (abs(d - int(n_buckets)), -d))
    order = np.argsort(sizes, kind="stable")
    groups = [g for g in np.array_split(order, b_eff) if len(g)]
    q = int(k) // len(groups)
    plan = []
    for g in groups:
        gsz = sizes[g]
        nb_full = max(1, -(-int(gsz.max()) // int(bs)))
        nb = nb_full
        if cap_ratio and cap_ratio > 0:
            cap = max(1, int(round(float(cap_ratio) * float(gsz.mean()))))
            nb = min(nb_full, max(1, -(-cap // int(bs))))
        quota = int(min(q, len(g)))
        capn = nb * int(bs)
        plan.append({
            "members": g.astype(np.int64),
            "q": quota,
            "nb": nb,
            "nb_full": nb_full,
            "padded": quota * capn,
            "real": float(quota * np.minimum(gsz, capn).mean()),
        })
    return plan


def build_aggregate(args: Any, algo: str, n_total: int,
                    flat_vars: FlatVariables,
                    server_tx: Optional[ServerOptimizer] = None):
    """Post-training logic of a round: the weighted aggregation, FedOpt's
    server step and the round metrics, on stacked per-client outputs.  The
    FedAvg and FedOpt arms are ported; robust aggregation and the
    SCAFFOLD/FedDyn/FedNova/Mime arms raise.

    FedOpt has two arms, as in the JAX package:

    * fused, when the server optimizer maps onto a channel of the fused
      epilogue (``spec_from_args``: adam, sgd with or without momentum):
      per dtype group, the parameter columns ``[0, P)`` of the stacked
      ``[C, D]`` buffer go through ``fused_epilogue`` — reduce →
      pseudo-gradient → optimizer → cast in one launch — and the BatchNorm
      columns ``[P, D)`` through ``weighted_reduce``, both written into the
      new global's buffer: two launches, and no slice is copied;
    * unfused (yogi, adagrad, or ``fused_epilogue: false``): ``agg_stacked``,
      then ``server_tx`` on the pseudo-gradient ``global − aggregate`` of
      the parameter columns.

    In both, the BatchNorm statistics take the plain weighted mean.

    ``aggregate`` writes the new global model into ``global_vars``' buffers
    and the server state into its tensors (the unfused arm copies its
    update's state back), so a round captured into a CUDA graph finds
    them where it left them; ``steps`` is the step table
    (``ops/epilogue.step_rows``) of the fused channel, or of the unfused
    adam's and yogi's bias corrections (its last two columns)."""
    if algo not in (FED_OPT_FEDAVG, FED_OPT_FEDOPT):
        raise NotImplementedError(
            f"Parrot aggregation for {algo!r} is not ported yet (port item "
            f"A9); the port runs {FED_OPT_FEDAVG} and {FED_OPT_FEDOPT}")
    if getattr(args, "robust_agg", None):
        raise NotImplementedError("robust_agg is not ported yet (port item "
                                  "A9)")
    fused_opt = spec_from_args(args) if algo == FED_OPT_FEDOPT else None

    def server_step(global_vars, opt_state, new_vars, weights, steps):
        if fused_opt is None:
            agg_vars = agg_stacked(new_vars, weights)
            bias_rows = None if steps is None else steps.rows[:, -2:]
            for dt in opt_state:
                cols = flat_vars.params_range(dt)
                g = global_vars[dt][cols]
                updates, new = server_tx.update(g - agg_vars[dt][cols],
                                                opt_state[dt], bias_rows)
                opt_state[dt] = _into_state(opt_state[dt], new)
                agg_vars[dt][cols] = apply_updates(g, updates)
            for dt, a in agg_vars.items():
                global_vars[dt].copy_(a)
            return
        for dt, x in new_vars.items():
            g = global_vars[dt]
            if dt not in opt_state:
                weighted_reduce(x, weights, out=g)
                continue
            cols, stats = flat_vars.params_range(dt), flat_vars.stats_range(dt)
            _, opt_state[dt] = fused_epilogue(
                g[cols], x[:, cols], weights, 1.0, fused_opt, opt_state[dt],
                out=g[cols], steps=steps)
            if stats.start < stats.stop:
                weighted_reduce(x[:, stats], weights, out=g[stats])

    def aggregate(global_vars: Dict[torch.dtype, torch.Tensor],
                  server_state: Dict[str, Any],
                  new_vars: Dict[torch.dtype, torch.Tensor],
                  metrics: Dict[str, torch.Tensor], weights: torch.Tensor,
                  steps: Optional[StepRows] = None
                  ) -> Tuple[Dict[torch.dtype, torch.Tensor], Dict[str, Any],
                             Dict[str, torch.Tensor]]:
        new_state = dict(server_state)
        if algo == FED_OPT_FEDOPT:
            new_state["opt_state"] = dict(server_state["opt_state"])
            server_step(global_vars, new_state["opt_state"], new_vars,
                        weights, steps)
        else:
            agg_stacked(new_vars, weights, out=global_vars)
        wsum = torch.clamp(weights.sum(), min=1e-12)
        round_metrics = {
            "train_loss": (metrics["train_loss"] * weights).sum() / wsum,
            "train_acc": (metrics["train_acc"] * weights).sum() / wsum,
            "samples": weights.sum(),
        }
        return global_vars, new_state, round_metrics

    return aggregate


def _into_state(old: Dict[str, Any], new: Dict[str, Any]) -> Dict[str, Any]:
    """An optimizer update's state written into ``old``'s tensors (other
    entries, such as optax's step count on the host, replaced); returns
    ``old``."""
    for k, v in new.items():
        if isinstance(v, torch.Tensor) and isinstance(old.get(k),
                                                      torch.Tensor):
            if v is not old[k]:
                old[k].copy_(v)
        else:
            old[k] = v
    return old


class ParrotAPI:
    #: rounds per chunk of ``run_rounds_fused``; the host reads the chunk's
    #: metrics once.  The JAX package's scan length; an instance may lower it
    FUSED_CHUNK_ROUNDS = 64

    def __init__(self, args: Any, device: Optional[torch.device],
                 dataset: Tuple, bundle: Any,
                 initial_variables: Optional[Dict[str, Any]] = None) -> None:
        """``initial_variables``: a JAX ``{"params", "batch_stats"}`` tree of
        numpy arrays to start from (``utils/weights.py``); by default the
        bundle's own seeded initialisation."""
        self.args = args
        self.bundle = bundle
        self.device = torch.device(device) if device is not None \
            else get_device(args)
        self.algo = str(getattr(args, "federated_optimizer", FED_OPT_FEDAVG))
        (self.train_num, self.test_num, self.train_global, self.test_global,
         self.local_num_dict, self.train_data_local_dict,
         self.test_data_local_dict, self.class_num) = dataset

        self.n_total = int(args.client_num_in_total)
        self.k = int(args.client_num_per_round)
        bs = int(getattr(args, "batch_size", 32))
        self.bs = bs
        max_n = max(self.local_num_dict.values())
        self.nb = max(1, -(-int(max_n) // bs))
        self.n_buckets = max(1, int(getattr(args, "hetero_buckets", 1) or 1))

        # ---- device-resident dataset; the index matrix stays on the host
        x_all, y_all = self.train_global
        self.device_data = {
            "x": torch.as_tensor(np.asarray(x_all), device=self.device).to(
                bundle.input_dtype),
            "y": torch.as_tensor(np.asarray(y_all), device=self.device)}
        cap = self.nb * bs
        idx_mat = np.full((self.n_total, cap), -1, np.int64)
        for cid in range(self.n_total):
            n_i = min(len(self.train_data_local_dict[cid][1]), cap)
            idx_mat[cid, :n_i] = self._find_rows(cid, n_i)
        self.idx_mat = torch.from_numpy(idx_mat)
        self.n_samples = torch.tensor(
            [float(self.local_num_dict[c]) for c in range(self.n_total)],
            dtype=torch.float32, device=self.device)

        # ---- model / engine ------------------------------------------------
        bundle.module.to(self.device)
        self.vars = FlatVariables(bundle.module)
        if initial_variables is not None:
            from_flax_variables(initial_variables, bundle.module)
        #: the global model: one flat buffer per dtype
        self.global_vars = self.vars.snapshot()
        self.local_update = build_local_update(bundle, args)
        self.eval_step = build_eval_step(bundle)
        self.seed = int(getattr(args, "random_seed", 0) or 0)
        self.dropout_rng = torch.Generator().manual_seed(
            self.seed + DROPOUT_SEED_OFFSET)

        # ---- server state: FedOpt's optimizer state per dtype group, over
        # its parameter columns — the fused epilogue's {m, v, t} when the
        # server optimizer maps onto a channel, optax's state otherwise
        self.server_state: Dict[str, Any] = {}
        self.server_tx: Optional[ServerOptimizer] = None
        #: the fused channel of FedOpt's server step; the spec of the step
        #: table (the fused channel's, or adam's for the unfused adam's and
        #: yogi's bias corrections) and the state key of its step count;
        #: the table; the step count as the host counts it
        self._spec = self._table_spec = None
        self._count_key = "t"
        self._steps: Optional[StepRows] = None
        self._t_host = 0
        if self.algo == FED_OPT_FEDOPT:
            spec = self._spec = self._table_spec = spec_from_args(args)
            if spec is None:
                self.server_tx = build_server_optimizer(args)
                if self.server_tx.betas is not None:
                    b1, b2 = self.server_tx.betas
                    self._table_spec = EpilogueSpec("adam", b1=b1, b2=b2)
                    self._count_key = "count"
            opt_state = {}
            for dt in self.vars.param_dtypes():
                p = self.global_vars[dt][self.vars.params_range(dt)]
                opt_state[dt] = (init_opt_state(p, spec) if spec is not None
                                 else self.server_tx.init(p))
            self.server_state["opt_state"] = opt_state
        self.aggregate = build_aggregate(args, self.algo, self.n_total,
                                         self.vars, self.server_tx)

        self._build_buckets()
        n_round = (sum(b["k"] for b in self.buckets) if self.buckets
                   else self.k)
        #: per-round client results: row c holds client c's trained state
        self.stacked = {dt: torch.empty((n_round, f.numel()), dtype=dt,
                                        device=self.device)
                        for dt, f in self.global_vars.items()}
        #: eval rounds, as the JAX package records them
        self.metrics_history: List[Dict[str, Any]] = []
        #: every round: train_loss, train_seconds, samples_trained
        self.round_history: List[Dict[str, Any]] = []

        # ---- fused rounds: built at the first run_rounds_fused
        #: the card generators of the round's draws and of its dropout
        self._fgen: Optional[torch.Generator] = None
        self._dgen: Optional[torch.Generator] = None
        self._graph: Optional[Any] = None
        self._chunk_rm: Optional[torch.Tensor] = None
        self._last_replays = 0
        #: capture and instantiate seconds of the round's graph, and per
        #: chunk its rounds, replays and host seconds
        self.fused_stats: Dict[str, Any] = {"chunks": []}

    def _build_buckets(self) -> None:
        """Split clients into size strata (``bucket_plan``); each round
        samples ``q`` clients per stratum and trains them at the stratum's
        batch capacity.  ``self.buckets`` is None on the uniform path."""
        self.bucket_cap = float(
            getattr(self.args, "hetero_bucket_cap", 0.0) or 0.0)
        if self.n_buckets <= 1:
            self.buckets = None
            return
        sizes = np.asarray([self.local_num_dict[c]
                            for c in range(self.n_total)])
        plan = bucket_plan(sizes, self.k, self.bs, self.n_buckets,
                           self.bucket_cap)
        if len(plan) <= 1:
            self.buckets = None
            self.n_buckets = 1
            return
        self.n_buckets = len(plan)
        idx_mat = self.idx_mat.numpy()
        self.buckets = []
        for b in plan:
            g = b["members"]
            # the index matrix keeps FULL capacity (largest member) so a
            # capped bucket's rotating window can address every sample;
            # the compute capacity nb may be smaller
            self.buckets.append({
                "gids": torch.from_numpy(g),
                "idx": torch.from_numpy(
                    np.ascontiguousarray(idx_mat[g, :b["nb_full"] * self.bs])),
                "sizes": torch.from_numpy(sizes[g].astype(np.int64)),
                "nb": b["nb"],
                "nb_full": b["nb_full"],
                "k": b["q"],
            })

    def _find_rows(self, cid: int, n_i: int) -> np.ndarray:
        """Global row indices of client cid's samples (the partition index
        map stashed by data_loader.load; recomputed identically if absent)."""
        rows_map = getattr(self.args, "client_row_map", None)
        if rows_map is None:
            from ...data.partition import partition
            y = np.asarray(self.train_global[1])
            labels = y if y.ndim == 1 else y[:, 0]
            m = partition(labels, self.n_total,
                          str(getattr(self.args, "partition_method",
                                      "hetero")),
                          float(getattr(self.args, "partition_alpha", 0.5)
                                or 0.5),
                          int(getattr(self.args, "random_seed", 0) or 0))
            rows_map = {c: np.asarray(m[c], np.int64) for c in m}
            setattr(self.args, "client_row_map", rows_map)
        return rows_map[cid][:n_i]

    # ---- batch gathering ----------------------------------------------
    def _gather_batches(self, data, client_ids, idx_mat, nb_b):
        """Padded per-client slots → [K, nb_b, bs] batch grids with masks."""
        return self._grid_from_idx(data, idx_mat[client_ids], nb_b)

    def _gather_batches_windowed(self, data, client_rows, idx_mat, sizes,
                                 nb_b, start):
        """Rotating-window gather for capped buckets: a client larger than
        the bucket's compute capacity contributes a circular window of
        ``nb_b·bs`` of its samples from ``start % n_i`` (``start``: one
        uniform draw per client) instead of a full epoch; everyone else
        reads their padded slots verbatim (index -1 padding masks the
        tail)."""
        capn = nb_b * self.bs
        rows = idx_mat[client_rows]                         # [K, full_cap]
        n_i = torch.clamp(sizes[client_rows], min=1)[:, None]
        j = torch.arange(capn, dtype=torch.int64, device=rows.device)[None, :]
        start = start.reshape(-1, 1).to(torch.int64) % n_i
        pos = torch.where(n_i > capn, (start + j) % n_i, j)
        return self._grid_from_idx(data, torch.gather(rows, 1, pos), nb_b)

    def _grid_from_idx(self, data, idx, nb_b):
        """``idx`` ([K, nb_b·bs] rows, -1 = padding) → device grids
        ``x``/``y``/``mask`` plus ``valid``, the [K, nb_b] flags of batches
        holding any real sample, where ``idx`` lies (the host, on the
        per-round path; the device, in the fused rounds)."""
        k, bs = idx.shape[0], self.bs
        dev = data["x"].device
        safe = torch.clamp(idx, min=0).to(dev)
        x, y = data["x"][safe], data["y"][safe]
        grid = (idx >= 0).reshape(k, nb_b, bs)
        return {"x": x.reshape((k, nb_b, bs) + tuple(x.shape[2:])),
                "y": y.reshape((k, nb_b, bs) + tuple(y.shape[2:])),
                "mask": grid.to(device=dev, dtype=torch.float32),
                "valid": grid.any(dim=2)}

    # ---- rounds ---------------------------------------------------------
    def _round_step(self, client_ids: np.ndarray) -> Dict[str, torch.Tensor]:
        ids = torch.from_numpy(client_ids.astype(np.int64))
        batches = self._gather_batches(self.device_data, ids, self.idx_mat,
                                       self.nb)
        return self._train_clients([(batches, ids)])

    def _bucketed_round_step(self, gen: torch.Generator
                             ) -> Dict[str, torch.Tensor]:
        """Proportionate-stratified sampling: ``q`` clients per stratum,
        each stratum at its own batch capacity."""
        parts = []
        for b in self.buckets:
            rows = torch.randperm(b["gids"].shape[0], generator=gen)[:b["k"]]
            if b["nb"] < b["nb_full"]:
                start = torch.randint(0, 1 << 30, (b["k"],), generator=gen)
                batches = self._gather_batches_windowed(
                    self.device_data, rows, b["idx"], b["sizes"], b["nb"],
                    start)
            else:
                batches = self._gather_batches(self.device_data, rows,
                                               b["idx"], b["nb"])
            parts.append((batches, b["gids"][rows]))
        return self._train_clients(parts)

    def _train_clients(self, parts, gated: bool = False
                       ) -> Dict[str, torch.Tensor]:
        """Train every client of ``parts`` ((batch grids, client ids) per
        stratum) from the global model into its row of ``self.stacked``,
        then aggregate into the new global model.  ``gated``: the gated
        local update on the grids' device flags (the fused rounds), else the
        host-skip one on flags read on the host."""
        per_client = []
        c = 0
        for batches, ids in parts:
            for i in range(ids.shape[0]):
                self.vars.load(self.global_vars)
                grid = {k: batches[k][i] for k in ("x", "y", "mask")}
                if gated:
                    m = self.gated_update(self.vars, grid,
                                          batches["valid"][i], self._dgen)
                else:
                    m = self.local_update(self.vars, grid,
                                          batches["valid"][i].tolist(),
                                          rng=self.dropout_rng)
                for dt, f in self.vars.flat.items():
                    self.stacked[dt][c].copy_(f)
                per_client.append(m)
                c += 1
        ids = torch.cat([ids for _, ids in parts]).to(self.device)
        metrics = {k: torch.stack([m[k] for m in per_client])
                   for k in ("train_loss", "train_acc", "n_samples")}
        self.global_vars, self.server_state, rm = self.aggregate(
            self.global_vars, self.server_state,
            {dt: s[:c] for dt, s in self.stacked.items()}, metrics,
            self.n_samples[ids], steps=self._steps)
        rm["samples_trained"] = metrics["n_samples"].sum()
        return rm

    def _ready_steps(self, more: int, on_device: bool) -> None:
        """For a server step that reads a step table (FedOpt's fused
        channel; the unfused adam's and yogi's bias corrections): a table
        that covers ``more`` further steps, and with ``on_device`` (the
        fused rounds) the step count moved onto the device from the host
        int a fresh or replaced state holds.  A new table drops the
        captured round, which reads the old one."""
        if self._table_spec is None:
            return
        key = self._count_key
        for st in self.server_state["opt_state"].values():
            if (st is not None and key in st
                    and not isinstance(st[key], torch.Tensor)):
                self._t_host = int(st[key])
                if on_device:
                    st[key] = torch.tensor(self._t_host, dtype=torch.int64,
                                           device=self.device)
        need = self._t_host + int(more)
        if self._steps is None or not self._steps.covers(need):
            n = max(need, int(self.args.comm_round)
                    + int(self.FUSED_CHUNK_ROUNDS))
            if self._steps is not None:
                n = max(n, 2 * self._steps.rows.shape[0])
            self._steps = step_rows(1.0, self._table_spec, n, self.device)
            self._graph = None

    def _client_sampling(self, round_idx: int) -> np.ndarray:
        if self.n_total == self.k:
            return np.arange(self.k, dtype=np.int32)
        np.random.seed(round_idx)  # reference parity (fedavg_api.py:127-136)
        return np.random.choice(self.n_total, self.k,
                                replace=False).astype(np.int32)

    def train(self) -> Dict[str, Any]:
        if getattr(self.args, "fused_rounds", False):
            return self._train_fused()
        return self._train_rounds()

    # ---- checkpoints ----------------------------------------------------
    def _checkpointer(self) -> Tuple[Optional[RoundCheckpointer], int]:
        """With ``checkpoint_dir``: its checkpointer, after restoring the
        newest checkpoint in place, and the round to start from."""
        ckpt_dir = getattr(self.args, "checkpoint_dir", None)
        if not ckpt_dir:
            return None, 0
        ckpt = RoundCheckpointer(str(ckpt_dir))
        state = ckpt.restore()
        if state is None:
            return ckpt, 0
        self._restore_state(state)
        start = int(np.asarray(state["round_idx"])) + 1
        logging.info("parrot: resumed from round %d", start - 1)
        return ckpt, start

    def _checkpoint_state(self, round_idx: int) -> Dict[str, Any]:
        """The JAX package's checkpoint layout: ``round_idx``, the global
        model as a JAX variables tree (``global_flax_variables``) and the
        server state, per dtype group name: its tensors copied to the host,
        its step counts as int64 scalars."""
        opt = self.server_state.get("opt_state")
        server: Dict[str, Any] = {}
        if opt is not None:
            server["opt_state"] = {
                _dtype_name(dt): None if st is None else {
                    k: _host_leaf(v) for k, v in st.items()}
                for dt, st in opt.items()}
        return {"round_idx": int(round_idx),
                "global_vars": self.global_flax_variables(),
                "server_state": server}

    def _restore_state(self, state: Dict[str, Any]) -> None:
        """Write a ``_checkpoint_state`` into this API in place: copied into
        the global buffers, the server state's tensors and the device step
        counts (a captured round reads their addresses); host counts
        replaced.  Raises on a state of another model or server step."""
        self.vars.load(self.global_vars)
        from_flax_variables(state["global_vars"], self.bundle.module)
        for dt, f in self.global_vars.items():
            f.copy_(self.vars.flat[dt])
        saved = (state.get("server_state") or {}).get("opt_state")
        opt = self.server_state.get("opt_state")
        if (saved is None) != (opt is None):
            raise ValueError("checkpoint: the saved server state does not "
                             "fit this server step")
        for dt, st in (opt or {}).items():
            name = _dtype_name(dt)
            src = saved.get(name, {})
            if (src is None) != (st is None) or set(src or ()) != set(
                    st or ()):
                raise ValueError(f"checkpoint: the saved {name} server "
                                 f"state does not fit this server step's "
                                 f"{sorted(st or ())}")
            for k, v in (st or {}).items():
                if isinstance(v, torch.Tensor) and v.dim() > 0:
                    leaf = src[k] if isinstance(src[k], torch.Tensor) \
                        else torch.from_numpy(np.array(src[k]))
                    if tuple(leaf.shape) != tuple(v.shape):
                        raise ValueError(f"checkpoint: {name} {k} of shape "
                                         f"{tuple(leaf.shape)}, not "
                                         f"{tuple(v.shape)}")
                    v.copy_(leaf)
                elif isinstance(v, torch.Tensor):
                    v.fill_(int(np.asarray(src[k])))
                else:
                    st[k] = int(np.asarray(src[k]))
                if k == self._count_key:
                    self._t_host = int(np.asarray(src[k]))

    def _train_rounds(self) -> Dict[str, Any]:
        comm_rounds = int(self.args.comm_round)
        gen = torch.Generator().manual_seed(self.seed + BUCKET_SEED_OFFSET)
        test_batches = self._make_test_batches()
        freq = int(getattr(self.args, "frequency_of_the_test", 5) or 5)
        ckpt_freq = int(getattr(self.args, "checkpoint_frequency", 10) or 10)
        ckpt, start = self._checkpointer()
        final_metrics: Dict[str, Any] = {}
        for round_idx in range(start, comm_rounds):
            t0 = time.perf_counter()
            self._ready_steps(1, on_device=False)
            self._t_host += 1
            if self.buckets is not None:
                rm = self._bucketed_round_step(gen)
            else:
                rm = self._round_step(self._client_sampling(round_idx))
            # reading the loss waits for the round to finish on the device
            train_loss = float(rm["train_loss"])
            self.round_history.append({
                "round": round_idx,
                "train_loss": train_loss,
                "train_seconds": time.perf_counter() - t0,
                "samples_trained": float(rm["samples_trained"]),
            })
            if round_idx % freq == 0 or round_idx == comm_rounds - 1:
                out = self.evaluate(test_batches)
                n = max(float(out["n"]), 1.0)
                final_metrics = self._record_metrics({
                    "test_loss": float(out["loss_sum"]) / n,
                    "test_acc": float(out["correct"]) / n,
                    "train_loss": train_loss,
                    "round": round_idx,
                    "round_time": time.perf_counter() - t0,
                }, f"parrot round {round_idx}")
            if ckpt is not None and (round_idx % ckpt_freq == 0
                                     or round_idx == comm_rounds - 1):
                ckpt.save(round_idx, self._checkpoint_state(round_idx))
        return final_metrics

    # ---- fused rounds ---------------------------------------------------
    def _fused_setup(self) -> None:
        """The fused rounds' device state: the generators (the draws', and
        dropout's where the model trains with dropout), the gated local
        update, the index matrices and strata on the device, the round's
        metrics buffer."""
        if self._fgen is not None:
            return
        dev = self.device
        self._fgen = torch.Generator(device=dev).manual_seed(
            self.seed + SAMPLE_SEED_OFFSET)
        if float(getattr(self.bundle.module, "dropout", 0.0) or 0.0) > 0:
            self._dgen = torch.Generator(device=dev).manual_seed(
                self.seed + DROPOUT_SEED_OFFSET)
        self.gated_update = build_local_update(self.bundle, self.args,
                                               gated=True)
        self._idx_dev = self.idx_mat.to(dev)
        for b in self.buckets or ():
            for k in ("gids", "idx", "sizes"):
                b[f"{k}_dev"] = b[k].to(dev)
        #: the round's train_loss, train_acc, samples and samples_trained
        self._rm = torch.zeros(4, dtype=torch.float32, device=dev)

    def _reseed(self, rng: Any) -> None:
        """Reseed the fused rounds' generators from ``rng``: an int seed, a
        ``torch.Generator`` to draw one 62-bit seed from, or None for
        ``seed + 23``.  The draws' generator takes the seed, dropout's the
        seed + 8, so None gives the fresh ``seed + 23`` and ``seed + 31``.
        Between replays only: a replay reads a registered generator's seed
        and offset when it starts."""
        if rng is None:
            seed = self.seed + SAMPLE_SEED_OFFSET
        elif isinstance(rng, torch.Generator):
            seed = int(torch.randint(0, 1 << 62, (), generator=rng,
                                     device=rng.device))
        elif isinstance(rng, (int, np.integer)):
            seed = int(rng)
        else:
            raise TypeError(f"rng must be an int seed, a torch.Generator or "
                            f"None, not {type(rng).__name__}")
        self._fgen.manual_seed(seed)
        if self._dgen is not None:
            self._dgen.manual_seed(
                seed + DROPOUT_SEED_OFFSET - SAMPLE_SEED_OFFSET)

    def _draw(self, n: int) -> torch.Tensor:
        """A uniform permutation of ``range(n)`` on the device: the order
        of ``n`` random 62-bit keys."""
        keys = torch.randint(0, 1 << 62, (n,), generator=self._fgen,
                             device=self.device)
        return torch.argsort(keys)

    def _fused_round(self) -> None:
        """One round with nothing read on the host: the draws, the gathers,
        every client's gated local update and the server step, its metrics
        into ``self._rm`` — the body a CUDA graph captures."""
        data = self.device_data
        if self.buckets is None:
            ids = self._draw(self.n_total)[:self.k]
            parts = [(self._gather_batches(data, ids, self._idx_dev,
                                           self.nb), ids)]
        else:
            parts = []
            for b in self.buckets:
                rows = self._draw(b["gids"].shape[0])[:b["k"]]
                if b["nb"] < b["nb_full"]:
                    start = torch.randint(0, 1 << 30, (b["k"],),
                                          generator=self._fgen,
                                          device=self.device)
                    batches = self._gather_batches_windowed(
                        data, rows, b["idx_dev"], b["sizes_dev"], b["nb"],
                        start)
                else:
                    batches = self._gather_batches(data, rows, b["idx_dev"],
                                                   b["nb"])
                parts.append((batches, b["gids_dev"][rows]))
        rm = self._train_clients(parts, gated=True)
        self._rm.copy_(torch.stack([rm["train_loss"], rm["train_acc"],
                                    rm["samples"], rm["samples_trained"]]))

    def _warm_round(self) -> None:
        """One uncaptured round on a side stream, as a capture wants its
        work warmed up: it builds the kernels and initialises the
        libraries.  A real round: its effects stand."""
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self._fused_round()
        main.wait_stream(side)

    def _capture(self) -> None:
        """Capture one round into a CUDA graph, the generators registered
        so that every replay draws anew, and instantiate it (the graph is
        kept: its nodes can be counted).  Capture records and runs nothing;
        a failure raises."""
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        for gen in (self._fgen, self._dgen):
            if gen is not None:
                graph.register_generator_state(gen)
        t0 = time.perf_counter()
        with torch.cuda.graph(graph):
            self._fused_round()
        t1 = time.perf_counter()
        graph.instantiate()
        self.fused_stats.update(capture_s=t1 - t0,
                                instantiate_s=time.perf_counter() - t1)
        self._graph = graph

    def _fused_chunk(self, step: int) -> torch.Tensor:
        """Enqueue ``step`` rounds and return the device rows of their
        metrics (``self._rm`` per round), reading nothing on the host.  On
        a card each round replays the captured round; with none captured
        yet, the chunk's first round runs uncaptured and is then captured.
        On the CPU every round runs uncaptured."""
        self._fused_setup()
        self._ready_steps(step, on_device=True)
        if self._chunk_rm is None or self._chunk_rm.shape[0] < step:
            self._chunk_rm = torch.zeros((step, 4), dtype=torch.float32,
                                         device=self.device)
        replays = 0
        for r in range(step):
            if self.device.type != "cuda":
                self._fused_round()
            elif self._graph is None:
                self._warm_round()
                self._capture()
            else:
                self._graph.replay()
                replays += 1
            self._chunk_rm[r].copy_(self._rm)
            self._t_host += 1
        self._last_replays = replays
        return self._chunk_rm[:step]

    def fused_graph_nodes(self) -> List[Tuple[str, str]]:
        """``(kind, kernel name)`` of each node of the captured round's
        CUDA graph (``ops/cuda_graphs.graph_nodes``)."""
        if self._graph is None:
            raise RuntimeError("no round has been captured: run "
                               "run_rounds_fused on a card first")
        return graph_nodes(self._graph)

    def run_rounds_fused(self, n_rounds: int, rng: Any = None
                         ) -> Dict[str, np.ndarray]:
        """Run ``n_rounds`` rounds in chunks of ``FUSED_CHUNK_ROUNDS``;
        returns the per-round ``train_loss``, ``train_acc`` and ``samples``
        (the weights' sum) as numpy arrays of length ``n_rounds``, read on
        the host once a chunk.  ``rng`` (an int seed, a ``torch.Generator``
        to draw one from, or None for ``seed + 23``) reseeds the draws
        before the first round, as the JAX package's key: calls with the
        same ``rng`` from the same state run the same rounds.  ``n_rounds``
        ≤ 0 returns empty arrays and touches no state."""
        remaining = int(n_rounds)
        if remaining <= 0:
            return {k: np.zeros((0,), np.float32)
                    for k in ("train_loss", "train_acc", "samples")}
        self._fused_setup()
        self._reseed(rng)
        out = []
        while remaining > 0:
            step = min(int(self.FUSED_CHUNK_ROUNDS), remaining)
            t0 = time.perf_counter()
            # reading the metrics waits for the chunk to finish on the device
            rms = self._fused_chunk(step).cpu().numpy().copy()
            secs = time.perf_counter() - t0
            self.fused_stats["chunks"].append(
                {"rounds": step, "replays": self._last_replays,
                 "seconds": secs})
            for loss, _, _, trained in rms:
                self.round_history.append({
                    "round": len(self.round_history),
                    "train_loss": float(loss),
                    "train_seconds": secs / step,
                    "samples_trained": float(trained)})
            out.append(rms)
            remaining -= step
        rms = np.concatenate(out)
        return {"train_loss": rms[:, 0], "train_acc": rms[:, 1],
                "samples": rms[:, 2]}

    def _train_fused(self) -> Dict[str, Any]:
        """``fused_rounds: true``: chunks of ``frequency_of_the_test``
        rounds through ``run_rounds_fused``, each reseeded from a host
        generator seeded ``seed + 23`` (the JAX package splits its key per
        chunk), an eval after each, and a checkpoint after each eval with
        ``checkpoint_dir``; ``round_time`` is the chunk's wall, eval
        included, per round."""
        comm_rounds = int(self.args.comm_round)
        freq = int(getattr(self.args, "frequency_of_the_test", 5) or 5)
        test_batches = self._make_test_batches()
        gen = torch.Generator().manual_seed(self.seed + SAMPLE_SEED_OFFSET)
        ckpt, done = self._checkpointer()
        final_metrics: Dict[str, Any] = {}
        while done < comm_rounds:
            t0 = time.perf_counter()
            step = min(freq, comm_rounds - done)
            rms = self.run_rounds_fused(step, rng=gen)
            done += step
            out = self.evaluate(test_batches)
            n = max(float(out["n"]), 1.0)
            final_metrics = self._record_metrics({
                "test_loss": float(out["loss_sum"]) / n,
                "test_acc": float(out["correct"]) / n,
                "train_loss": float(rms["train_loss"][-1]),
                "round": done - 1,
                "round_time": (time.perf_counter() - t0) / step,
            }, f"parrot fused rounds {done - step}-{done - 1}")
            if ckpt is not None:
                ckpt.save(done - 1, self._checkpoint_state(done - 1))
        return final_metrics

    def evaluate(self, test_batches: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
        """``eval_step`` on the global model."""
        self.vars.load(self.global_vars)
        return self.eval_step(test_batches)

    def global_flax_variables(self) -> Dict[str, Any]:
        """The global model as a JAX variables tree of numpy arrays."""
        self.vars.load(self.global_vars)
        return to_flax_variables(self.bundle.module)

    def _make_test_batches(self) -> Dict[str, torch.Tensor]:
        x_te, y_te = self.test_global
        nb_te = max(1, -(-len(y_te) // self.bs))
        return make_batches(x_te, y_te, self.bs, nb_te,
                            self.bundle.input_dtype, self.device)

    def _record_metrics(self, metrics: Dict[str, Any], tag: str
                        ) -> Dict[str, Any]:
        self.metrics_history.append(metrics)
        logging.info("%s: %s", tag, metrics)
        return metrics


def _dtype_name(dt: torch.dtype) -> str:
    """``torch.float32`` → ``"float32"``: a dtype group's key in a
    checkpoint."""
    return str(dt).rpartition(".")[2]


def _host_leaf(v: Any) -> Any:
    """A server-state entry as a checkpoint holds it: a tensor copied to
    the host (``utils/serialization`` writes it), a step count — a host
    int or a 0-d device tensor — as an int64 scalar."""
    if isinstance(v, torch.Tensor) and v.dim() > 0:
        return v.detach().cpu()
    return np.asarray(int(v), np.int64)
