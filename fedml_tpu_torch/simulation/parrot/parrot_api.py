"""Parrot — federated simulation on one device.

Port of ``fedml_tpu/simulation/parrot/parrot_api.py``: ``bucket_plan``, the
FedAvg arm of ``build_aggregate`` and ``ParrotAPI``'s per-round path — the
uniform round and the size-bucketed round.

A round here:

* samples clients on the host;
* gathers each sampled client's padded batch grid from the device-resident
  dataset (the index arithmetic runs on the host, the gather on the device);
* trains the sampled clients one after another — the JAX package vmaps
  them, and with one client per stratum (the north-star config) a loop
  computes the same thing — each into row ``c`` of a stacked ``[C, D]``
  buffer per dtype (``FlatVariables``);
* reduces the stacked buffers with the weighted-reduce kernel, one launch
  per dtype, weighted by each client's full sample count.

Deviation from the reference: the bucketed round draws its clients and its
window starts with a seeded ``torch.Generator`` (``seed + 17``), where the
JAX package draws them with ``jax.random``; the distribution is the same
(quota ``q`` per stratum without replacement, uniform window start mod the
client's size), the draws are not.  The uniform round's
``np.random.seed(round)`` draw is the reference's, exactly.

Not ported yet: the fused multi-round scan, the AOT cache and compile-ahead,
mesh/remesh/resize, checkpoint-resume and the flight recorder.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ...constants import FED_OPT_FEDAVG
from ...ml.aggregator.agg_operator import agg_stacked
from ...ml.engine.device import get_device
from ...ml.engine.local_update import (
    build_eval_step,
    build_local_update,
    make_batches,
)
from ...ml.engine.model_bundle import FlatVariables
from ...utils.weights import from_flax_variables, to_flax_variables


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


def build_aggregate(args: Any, algo: str, n_total: int):
    """Post-training logic of a round: the weighted aggregation and the
    round metrics, on stacked per-client outputs.  Only the FedAvg arm is
    ported; robust aggregation and the FedOpt/SCAFFOLD/FedDyn/FedNova/Mime
    arms raise."""
    if algo != FED_OPT_FEDAVG:
        raise NotImplementedError(
            f"Parrot aggregation for {algo!r} is not ported yet; the port "
            f"runs {FED_OPT_FEDAVG}")
    if getattr(args, "robust_agg", None):
        raise NotImplementedError("robust_agg is not ported yet")

    def aggregate(new_vars: Dict[torch.dtype, torch.Tensor],
                  metrics: Dict[str, torch.Tensor], weights: torch.Tensor
                  ) -> Tuple[Dict[torch.dtype, torch.Tensor],
                             Dict[str, torch.Tensor]]:
        agg_vars = agg_stacked(new_vars, weights)
        wsum = torch.clamp(weights.sum(), min=1e-12)
        round_metrics = {
            "train_loss": (metrics["train_loss"] * weights).sum() / wsum,
            "train_acc": (metrics["train_acc"] * weights).sum() / wsum,
            "samples": weights.sum(),
        }
        return agg_vars, round_metrics

    return aggregate


class ParrotAPI:
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
        if getattr(args, "fused_rounds", False):
            raise NotImplementedError("fused_rounds is not ported yet")

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
        self.aggregate = build_aggregate(args, self.algo, self.n_total)

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
            m = partition(np.asarray(self.train_global[1]), self.n_total,
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
        j = torch.arange(capn, dtype=torch.int64)[None, :]
        start = start.reshape(-1, 1).to(torch.int64) % n_i
        pos = torch.where(n_i > capn, (start + j) % n_i, j)
        return self._grid_from_idx(data, torch.gather(rows, 1, pos), nb_b)

    def _grid_from_idx(self, data, idx, nb_b):
        """``idx`` ([K, nb_b·bs] host rows, -1 = padding) → device grids
        ``x``/``y``/``mask`` plus ``valid``, the host [K, nb_b] flags of
        batches holding any real sample."""
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

    def _train_clients(self, parts) -> Dict[str, torch.Tensor]:
        """Train every client of ``parts`` ((batch grids, client ids) per
        stratum) from the global model into its row of ``self.stacked``,
        then aggregate into the new global model."""
        per_client = []
        c = 0
        for batches, ids in parts:
            for i in range(ids.shape[0]):
                self.vars.load(self.global_vars)
                m = self.local_update(
                    self.vars,
                    {k: batches[k][i] for k in ("x", "y", "mask")},
                    batches["valid"][i].tolist())
                for dt, f in self.vars.flat.items():
                    self.stacked[dt][c].copy_(f)
                per_client.append(m)
                c += 1
        ids = torch.cat([ids for _, ids in parts]).to(self.device)
        metrics = {k: torch.stack([m[k] for m in per_client])
                   for k in ("train_loss", "train_acc", "n_samples")}
        self.global_vars, rm = self.aggregate(
            {dt: s[:c] for dt, s in self.stacked.items()}, metrics,
            self.n_samples[ids])
        rm["samples_trained"] = metrics["n_samples"].sum()
        return rm

    def _client_sampling(self, round_idx: int) -> np.ndarray:
        if self.n_total == self.k:
            return np.arange(self.k, dtype=np.int32)
        np.random.seed(round_idx)  # reference parity (fedavg_api.py:127-136)
        return np.random.choice(self.n_total, self.k,
                                replace=False).astype(np.int32)

    def train(self) -> Dict[str, Any]:
        return self._train_rounds()

    def _train_rounds(self) -> Dict[str, Any]:
        comm_rounds = int(self.args.comm_round)
        seed = int(getattr(self.args, "random_seed", 0) or 0)
        gen = torch.Generator().manual_seed(seed + 17)
        test_batches = self._make_test_batches()
        freq = int(getattr(self.args, "frequency_of_the_test", 5) or 5)
        final_metrics: Dict[str, Any] = {}
        for round_idx in range(comm_rounds):
            t0 = time.perf_counter()
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
