"""Batched inference engine (PyTorch).

Counterpart of `jaeger_tpu/infer/engine.py`: windows stream
through the model in fixed-size batches (the last one padded and
trimmed); base IDs cross host->device nibble-packed (two per byte) and
are unpacked on the device; logits come back in float32. Per batch, one
host scan picks the program, exactly as the JAX engine does, so batch
order and outputs match it:

* dense (``assume_dense``): every window fills the crop with unambiguous
  bases, no mask at all;
* bounded: the mask runs only up to a ``mask_cut_plan`` cut, after which
  it is provably all-true;
* masked: the full masked program;
* split-mixed: a mostly clean batch runs the dense (or bounded) program
  on all rows and the masked program on the few masked rows gathered
  into a bucket of bs/16 or bs/8 rows, scattered back in place.

With ``int8_model`` (``predict --int8 auto``) the dense program, also as
the base of a split batch, runs on that model, as the JAX engine's
``_vars_for`` does (for nucleotide models too); every other program runs
on the float model. A model without a ``config`` (an
:class:`~jaeger_tpu_torch.models.ensemble.EnsembleModel`) has no
bounded-mask cuts, as in the JAX engine's ``_mask_plans``.

Data parallel (``mesh``, a :class:`~jaeger_tpu_torch.parallel.mesh.
DeviceMesh`, as JAX's data mesh): the batch size is padded to a multiple
of the mesh size, the split bucket is a multiple of it, each program's
rows are cut into one equal share a device, each device runs its own
replica of the model on its share, and the outputs are gathered back in
row order on the first device. Eval mode has no cross-row state, so no
collective runs. ``seq_mesh``: a model built with ``parallel.seq_axis``
runs its Hyena blocks length-sharded over that mesh
(:mod:`jaeger_tpu_torch.parallel.hyena_sp`); the two meshes exclude each
other.

Pipelining: on CUDA the packed bases are copied from pinned host memory
with ``non_blocking=True`` and the forward is enqueued without waiting,
so up to ``PIPELINE_DEPTH`` batches are in flight; the host plans and
packs the next batch while the device runs the earlier ones, and a
batch's outputs are copied back (which waits for that batch only) once
the queue is deeper than ``PIPELINE_DEPTH``.

Spans (:mod:`jaeger_tpu_torch.utils.spans`): ``engine/batch`` around each
batch's host work, with ``engine/plan``, ``engine/pack``,
``engine/upload``, ``engine/forward`` (the unpack and the model's
enqueue), ``engine/reduce``, ``engine/drain`` (the waits for an earlier
batch's outputs) and ``engine/accumulate`` inside it; its self time is the
padding, segment maps and bucket gathering.
"""

from __future__ import annotations

import collections
import logging
import time
from typing import Iterable

import numpy as np
import torch

from jaeger_tpu_torch.models.builder import mask_cut_plan
from jaeger_tpu_torch.ops.encode import (bounded_mask_levels,
                                         dense_window_rows, pack_bases,
                                         unpack_bases)
from jaeger_tpu_torch.ops.reduce import ContigAccumulator, contig_partials
from jaeger_tpu_torch.parallel.mesh import pad_to_multiple, use_mesh
from jaeger_tpu_torch.seqops.windows import WindowBatch
from jaeger_tpu_torch.utils.devices import resolve_device
from jaeger_tpu_torch.utils.spans import span

logger = logging.getLogger("jaeger_tpu_torch")

#: batches enqueued on the device before the host waits for the oldest
PIPELINE_DEPTH = 4


class InferenceEngine:
    def __init__(
        self,
        model,
        batch_size: int = 512,
        device=None,
        output_keys: tuple | None = None,
        split_mixed: bool = True,
        int8_model=None,
        mesh=None,
        seq_mesh=None,
    ):
        if mesh is not None and seq_mesh is not None:
            raise ValueError("mesh and seq_mesh are mutually exclusive")
        self.mesh = mesh
        self.seq_mesh = seq_mesh
        if mesh is not None:
            for dev in mesh.devices:
                resolve_device(dev)
            device = mesh.devices[0]
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        # `predict --int8 auto`: the dense program, and the dense base
        # program of a split batch, run on the int8 model (full-length,
        # unambiguous windows); bounded, masked and bucket programs keep
        # the float model
        self.int8_model = (None if int8_model is None
                           else int8_model.to(self.device).eval())
        self.batch_size = int(batch_size)
        if mesh is not None:
            # data parallel: a replica of each model on each device, the
            # batch padded to a device multiple
            self.batch_size = pad_to_multiple(self.batch_size, mesh.size)
            self._replicas = {id(m): mesh.replicate(m)
                              for m in (self.model, self.int8_model)
                              if m is not None}
        self.output_keys = tuple(output_keys) if output_keys else None
        self.split_mixed = bool(split_mixed)
        cfg = getattr(model, "config", None) or {}
        self._plans = mask_cut_plan(
            cfg.get("representation_learner", {})) or []
        #: forwards run, keyed by (rows, program): "dense", "masked" or
        #: ("bounded", cut)
        self.program_counts: collections.Counter = collections.Counter()
        #: forwards that ran on ``int8_model``
        self.int8_forwards = 0

    def _plan_batch(self, bases: np.ndarray, lengths: np.ndarray,
                    n_valid: int):
        """One host scan -> (dense, split, mask_cut), as the JAX engine.

        ``split`` is (masked_idx, bucket) when the batch runs as base
        program on all rows + masked bucket on the few; ``mask_cut``
        selects the bounded program as the base. (False, None, None) is
        the plain masked program."""
        with span("engine/plan"):
            crop = getattr(self.model, "crop_nt", None)
            if crop is None or n_valid == 0:
                return False, None, None
            masking = getattr(self.model, "masking_enabled", True)
            rows = dense_window_rows(bases[:n_valid], lengths[:n_valid],
                                     crop, masking)
            if rows.all():
                return True, None, None

            bs = self.batch_size
            mult = self.mesh.size if self.mesh is not None else 1

            def bucket_for(k: int):
                for b in (bs // 16, bs // 8):
                    b = -(-max(b, 1) // mult) * mult
                    if b >= bs:
                        break
                    if k <= b:
                        return b
                return None

            if self.split_mixed and rows.any():
                masked_idx = np.nonzero(~rows)[0]
                b = bucket_for(masked_idx.size)
                if b is not None:
                    return False, (masked_idx, b), None
            plans = self._plans
            if plans:
                levels = bounded_mask_levels(
                    bases[:n_valid], lengths[:n_valid], crop, masking, plans)
                bad_idx = np.nonzero(levels < 0)[0]
                if bad_idx.size == 0:
                    return False, None, plans[int(levels.max())][0]
                if self.split_mixed and bad_idx.size < n_valid:
                    b = bucket_for(bad_idx.size)
                    if b is not None:
                        cut = plans[int(levels[levels >= 0].max())][0]
                        return False, (bad_idx, b), cut
            return False, None, None  # plain masked program

    @staticmethod
    def _gather_masked(b: np.ndarray, ln: np.ndarray,
                       midx: np.ndarray, bucket: int):
        """(bucket bases, bucket lengths, neutralized b, neutralized ln):
        the masked rows move into the bucket (N-padded past m); their
        slots in the dense run get well-formed placeholder windows whose
        outputs are discarded."""
        m = midx.size
        mb = np.full((bucket, b.shape[1]), 4, np.uint8)
        mb[:m] = b[midx]
        mln = np.zeros(bucket, np.int32)
        mln[:m] = ln[midx]
        b = b.copy()
        ln = np.asarray(ln).copy()
        b[midx] = 0
        ln[midx] = b.shape[1]
        return mb, mln, b, ln

    def _to_device(self, arr: np.ndarray, device=None) -> torch.Tensor:
        device = self.device if device is None else device
        with span("engine/upload"):
            t = torch.from_numpy(np.ascontiguousarray(arr))
            if device.type == "cuda":
                return t.pin_memory().to(device, non_blocking=True)
            return t

    def _forward(self, bases: np.ndarray, lengths: np.ndarray,
                 dense: bool = False, mask_cut=None) -> dict:
        """Enqueue one forward; returns device float32 outputs (on the
        first device of a data mesh, gathered in row order)."""
        mask_cut = None if dense else mask_cut
        program = ("dense" if dense else "masked" if mask_cut is None
                   else ("bounded", mask_cut))
        self.program_counts[(bases.shape[0], program)] += 1
        model = self.model
        if dense and self.int8_model is not None:
            model = self.int8_model
            self.int8_forwards += 1
        with span("engine/pack"):
            packed = pack_bases(bases)
        lengths = np.asarray(lengths, np.int32)
        if self.mesh is None:
            return self._run(model, self.device, packed, lengths,
                             bases.shape[1], dense, mask_cut)
        # each device runs its replica on its rows; no collective (eval
        # mode has no cross-row state)
        n = self.mesh.size
        per = bases.shape[0] // n
        parts = [self._run(replica, dev, packed[i * per:(i + 1) * per],
                           lengths[i * per:(i + 1) * per], bases.shape[1],
                           dense, mask_cut)
                 for i, (replica, dev) in enumerate(zip(
                     self._replicas[id(model)], self.mesh.devices))]
        return {k: self.mesh.gather([p[k] for p in parts])
                for k in parts[0]}

    def _run(self, model, device, packed, lengths, width: int, dense: bool,
             mask_cut) -> dict:
        dev_packed = self._to_device(packed, device)
        ln = self._to_device(lengths, device)
        with span("engine/forward"):
            dev_bases = unpack_bases(dev_packed, width)
            with torch.inference_mode(), use_mesh(self.seq_mesh):
                out = model(dev_bases, ln, assume_dense=dense,
                            mask_layers=mask_cut)
            if self.output_keys is not None:
                out = {k: v for k, v in out.items() if k in self.output_keys}
            return {k: v.float() for k, v in out.items()}

    def predict_windows(
        self, bases: np.ndarray, lengths: np.ndarray
    ) -> dict[str, np.ndarray]:
        """Run the model over (n, cap) base IDs; returns host float32."""
        n = bases.shape[0]
        bs = self.batch_size
        chunks: list[dict[str, np.ndarray]] = []
        # (device outputs, valid rows, None | (masked outputs, idx, m))
        in_flight: list[tuple[dict, int, tuple | None]] = []

        def drain_one() -> None:
            out, valid, merge = in_flight.pop(0)
            with span("engine/drain"):
                host = {k: v.cpu().numpy() for k, v in out.items()}
                if merge is not None:
                    out_m, midx, m = merge
                    for k, v in host.items():
                        v[midx] = out_m[k][:m].cpu().numpy()
            chunks.append({k: v[:valid] for k, v in host.items()})

        for i in range(0, n, bs):
            with span("engine/batch"):
                b = bases[i: i + bs]
                ln = lengths[i: i + bs]
                valid = b.shape[0]
                dense, split, mask_cut = self._plan_batch(b, ln, valid)
                pad = bs - valid
                if pad:
                    b = np.pad(b, ((0, pad), (0, 0)), constant_values=4)
                    ln = np.pad(ln, (0, pad), constant_values=0)
                merge = None
                if split is not None:
                    midx, bucket = split
                    mb, mln, b, ln = self._gather_masked(b, ln, midx, bucket)
                    merge = (self._forward(mb, mln), midx, midx.size)
                    dense = mask_cut is None
                out = self._forward(b, ln, dense, mask_cut)
                in_flight.append((out, valid, merge))
                if len(in_flight) > PIPELINE_DEPTH:
                    drain_one()
        while in_flight:
            drain_one()
        if not chunks:
            return {}
        return {
            k: np.concatenate([c[k] for c in chunks], axis=0)
            for k in chunks[0]
        }

    def _forward_reduced(self, bases, lengths, seg_ids, valid,
                         with_reliability: bool, dense: bool = False,
                         mask_cut=None) -> dict:
        out = self._forward(bases, lengths, dense, mask_cut)
        seg_ids, valid = self._to_device(seg_ids), self._to_device(valid)
        with span("engine/reduce"):
            return contig_partials(
                out["prediction"], seg_ids, valid,
                num_segments=bases.shape[0],
                reliability=(out["reliability"] if with_reliability
                             and "reliability" in out else None))

    def predict_batches_reduced(
        self, batches: Iterable[WindowBatch], num_classes: int,
        with_reliability: bool = True,
    ):
        """Stream batches through the device-reduced path.

        Returns (ContigAccumulator-final stats keyed by global contig
        index, kept WindowBatches).
        """
        acc = ContigAccumulator(num_classes, with_reliability)
        kept: list[WindowBatch] = []
        bs = self.batch_size
        in_flight: list[tuple] = []

        def drain_one():
            partial, seg_to_contig, win_contigs, n_valid, merge = (
                in_flight.pop(0))
            with span("engine/drain"):
                p = {k: v.cpu().numpy() for k, v in partial.items()}
                if merge is not None:
                    pm = {k: v.cpu().numpy() for k, v in merge[0].items()}
            with span("engine/accumulate"):
                if merge is None:
                    acc.add_batch(p, seg_to_contig, win_contigs)
                    return
                # split execution: statistics arrive as two partial
                # batches; per-window classes are scattered back into
                # stream order
                _, seg_to_m, midx, m = merge
                cls = p["window_cls"].copy()
                cls[midx] = pm["window_cls"][:m]
                acc.add_batch(p, seg_to_contig, win_contigs,
                              window_cls=cls[:n_valid])
                acc.add_batch(pm, seg_to_m, None)

        def seg_maps(contig_ids: np.ndarray, n_seg: int):
            # dense segment ids: global contig indices have gaps
            uniq, seg_local = np.unique(contig_ids, return_inverse=True)
            seg_to_contig = np.full(n_seg, uniq[-1], dtype=np.int64)
            seg_to_contig[: uniq.size] = uniq
            return seg_local.astype(np.int32), seg_to_contig

        for batch in batches:
            if len(batch) == 0:
                continue
            kept.append(batch)
            for i in range(0, len(batch), bs):
                with span("engine/batch"):
                    b = batch.bases[i: i + bs]
                    ln = batch.length[i: i + bs]
                    contig = batch.contig[i: i + bs].astype(np.int64)
                    n_valid = b.shape[0]
                    dense, split, mask_cut = self._plan_batch(b, ln, n_valid)
                    pad = bs - n_valid
                    if pad:
                        b = np.pad(b, ((0, pad), (0, 0)), constant_values=4)
                        ln = np.pad(ln, (0, pad))
                        contig = np.pad(contig, (0, pad),
                                        constant_values=contig[-1])
                    seg_local, seg_to_contig = seg_maps(contig, bs)
                    valid = np.zeros(bs, bool)
                    valid[:n_valid] = True
                    merge = None
                    if split is not None:
                        midx, bucket = split
                        m = midx.size
                        mb, mln, b, ln = self._gather_masked(b, ln, midx,
                                                             bucket)
                        seg_m, seg_to_m = seg_maps(contig[midx], bucket)
                        seg_m = np.pad(seg_m, (0, bucket - m))
                        valid_m = np.zeros(bucket, bool)
                        valid_m[:m] = True
                        partial_m = self._forward_reduced(
                            mb, mln, seg_m, valid_m, with_reliability)
                        # the base run covers everything else; its masked
                        # slots hold placeholders, excluded from the sums
                        valid[midx] = False
                        merge = (partial_m, seg_to_m, midx, m)
                        dense = mask_cut is None
                    partial = self._forward_reduced(
                        b, ln, seg_local, valid, with_reliability, dense,
                        mask_cut)
                    in_flight.append(
                        (partial, seg_to_contig, contig[:n_valid], n_valid,
                         merge))
                    if len(in_flight) > PIPELINE_DEPTH:
                        drain_one()
        while in_flight:
            drain_one()
        return acc.finalize(), kept

    def predict_batches(
        self, batches: Iterable[WindowBatch]
    ) -> tuple[dict[str, np.ndarray], list[WindowBatch]]:
        """Stream WindowBatches; returns concatenated outputs + kept batches."""
        kept: list[WindowBatch] = []
        outs: list[dict[str, np.ndarray]] = []
        t0 = time.time()
        done = 0
        for batch in batches:
            if len(batch) == 0:
                continue
            kept.append(batch)
            outs.append(self.predict_windows(batch.bases, batch.length))
            done += len(batch)
            elapsed = time.time() - t0
            logger.info(
                f"inference: {done} windows "
                f"({done / max(elapsed, 1e-9):,.0f} windows/s)"
            )
        if not outs:
            return {}, kept
        merged = {
            k: np.concatenate([o[k] for o in outs], axis=0) for k in outs[0]
        }
        return merged, kept
