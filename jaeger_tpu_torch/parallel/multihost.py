"""Counterpart of `jaeger_tpu/parallel/multihost.py`: multi-host scale-out.

* **Contig sharding** (``predict --num-hosts N --host-id K``): each host
  process reads the shared FASTA and keeps only the contigs a
  deterministic hash assigns it (:func:`contig_owner`), so no contig's
  windows span hosts; each host writes a TSV shard
  (``<stem>_default_jaeger.tsv.shard<K>``) and whichever finishes last
  merges them (:func:`merge_when_complete`). The helpers are copies of
  the JAX module's; the merge, which JAX's two last hosts may run at
  once, is taken by one host under :func:`merge_lock`.
* **Training** (``train --coordinator HOST:PORT --num-processes N
  --process-id K``): :func:`initialize_distributed` joins a
  ``torch.distributed`` process group (``nccl`` for CUDA devices,
  ``gloo`` for the CPU, or the backend the caller names), one process per
  device. Every process iterates the same deterministic global batch
  stream; :class:`GlobalBatcher` keeps this process's row slice
  ``[r·B/N, (r+1)·B/N)``, as ``jax.make_array_from_process_local_data``
  takes each process's addressable rows. The step all-reduces the
  gradients (one flat buffer) and the batch statistics
  (:func:`all_reduce_sum`, differentiable), so the parameters stay the
  same on every process; filesystem writes are the primary's
  (:func:`is_primary`).

Without an initialized process group every function here is the
one-process case: rank 0 of 1, primary, no collective.
"""

from __future__ import annotations

import contextlib
import datetime
import logging
import os
import zlib
from pathlib import Path

import torch

#: seconds a collective may wait for the other processes before it fails
DEFAULT_TIMEOUT_S = 300

logger = logging.getLogger("jaeger_tpu_torch")


def contig_owner(header: str, num_hosts: int) -> int:
    """Deterministic contig -> host assignment (stable across runs)."""
    return zlib.crc32(header.encode("utf-8")) % max(1, num_hosts)


def filter_contigs_for_host(records, host_id: int, num_hosts: int):
    """Filter an iterable of (header, seq) down to this host's share."""
    for header, seq in records:
        if contig_owner(header, num_hosts) == host_id:
            yield header, seq


def shard_path(base: str | Path, host_id: int) -> Path:
    return Path(f"{base}.shard{host_id:03d}")


def merge_output_shards(base: str | Path, num_hosts: int,
                        delete: bool = True) -> Path:
    """Merge per-host TSV shards into the final table.

    The header comes from the first non-empty shard (a host that owned
    zero contigs writes an empty shard so completion is detectable).
    Written via a temp file + rename. Not safe against a second merge of
    the same shards: it skips the shards the first one deleted and
    renames its short table over the whole one. Hosts merge through
    :func:`merge_when_complete`, which lets one of them in."""
    base = Path(base)
    tmp = base.with_name(base.name + ".merging")
    with open(tmp, "w") as out:
        wrote_header = False
        for host in range(num_hosts):
            p = shard_path(base, host)
            if not p.exists():
                continue
            with open(p) as fh:
                for i, line in enumerate(fh):
                    if i == 0:
                        if wrote_header:
                            continue
                        wrote_header = True
                    out.write(line)
    tmp.replace(base)
    if delete:
        for host in range(num_hosts):
            shard_path(base, host).unlink(missing_ok=True)
    return base


@contextlib.contextmanager
def merge_lock(base: str | Path):
    """Hold ``<base>.lock`` for one merge: yields True in the process that
    created it (``O_EXCL``, atomic on a shared filesystem too) and removes
    it on leaving; False while another process holds it."""
    lock = Path(f"{base}.lock")
    try:
        fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    except FileExistsError:
        logger.info(f"{lock} is held: another host merges (remove it if no "
                    f"merge is running)")
        yield False
        return
    try:
        yield True
    finally:
        os.close(fd)
        lock.unlink(missing_ok=True)


def merge_when_complete(base: str | Path, num_hosts: int,
                        also: tuple = ()) -> Path | None:
    """Merge ``base``'s shards, and those of each table in ``also`` that
    has any, once every host's ``base`` shard is there; one process
    merges: the one that takes :func:`merge_lock` while the shards are
    still present. Returns the merged table, or None when shards are
    outstanding, another host is merging or has merged them already.
    A host renames its finished shard into place, so a shard that exists
    is whole."""
    def complete():
        return all(shard_path(base, h).exists() for h in range(num_hosts))

    if not complete():
        return None
    with merge_lock(base) as held:
        if not held or not complete():
            return None
        merged = merge_output_shards(base, num_hosts)
        for other in also:
            if any(shard_path(other, h).exists() for h in range(num_hosts)):
                merge_output_shards(other, num_hosts)
    return merged


def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def default_backend(device) -> str:
    """``nccl`` for a CUDA device, ``gloo`` otherwise."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize_distributed(coordinator: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           backend: str | None = None, device="cuda",
                           timeout_s: float = DEFAULT_TIMEOUT_S
                           ) -> tuple[int, int]:
    """Join the process group at ``tcp://<coordinator>`` when a
    coordinator is given; returns (process_id, num_processes), (0, 1)
    without one. ``backend`` defaults to :func:`default_backend` of
    ``device``; ``timeout_s`` bounds every collective, so a process that
    skips one fails instead of hanging the others."""
    if coordinator:
        import torch.distributed as dist

        if num_processes is None or process_id is None:
            raise ValueError("--coordinator needs --num-processes and "
                             "--process-id")
        dist.init_process_group(
            backend or default_backend(device),
            init_method=f"tcp://{coordinator}", world_size=int(num_processes),
            rank=int(process_id),
            timeout=datetime.timedelta(seconds=float(timeout_s)))
    return process_index(), process_count()


def shutdown_distributed() -> None:
    """Leave the process group, if this process joined one."""
    dist = _dist()
    if dist is not None:
        dist.destroy_process_group()


def process_index() -> int:
    dist = _dist()
    return dist.get_rank() if dist is not None else 0


def process_count() -> int:
    dist = _dist()
    return dist.get_world_size() if dist is not None else 1


def is_distributed() -> bool:
    """True inside a process group, of any size (a one-process group
    still runs the collectives)."""
    return _dist() is not None


def is_multiprocess() -> bool:
    return process_count() > 1


def is_primary() -> bool:
    """True on the process that owns filesystem writes (checkpoints,
    exports, CSV logs, convergence markers). Always True single-process."""
    return process_index() == 0


def rank_device(device, process_id: int) -> torch.device:
    """The device of process ``process_id``: ``cuda`` (no index) means
    one card per process, ``cuda:<process_id mod the card count>``; a
    device with an index, or the CPU, is kept as given."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        n = torch.cuda.device_count()
        if n:
            return torch.device("cuda", int(process_id) % n)
    return dev


class _AllReduceSum(torch.autograd.Function):
    """Sum over the process group, forward and backward: the backward
    all-reduces the cotangent, so the gradient that flows through a
    global statistic reaches every process's inputs."""

    @staticmethod
    def forward(ctx, x):
        y = x.contiguous().clone()
        _dist().all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        _dist().all_reduce(g)
        return g


def all_reduce_sum(*xs: torch.Tensor):
    """Each of ``xs`` summed over the process group by one differentiable
    all-reduce (they broadcast to one shape); ``xs`` themselves outside
    one. One tensor in, one out; several in, a tuple out."""
    if _dist() is None:
        return xs[0] if len(xs) == 1 else xs
    if len(xs) == 1:
        return _AllReduceSum.apply(xs[0])
    return tuple(_AllReduceSum.apply(
        torch.stack(torch.broadcast_tensors(*xs))).unbind(0))


def all_reduce_mean(tensors: dict) -> dict:
    """The mean over the process group of each tensor of ``tensors``, by
    one all-reduce of one flat f32 buffer (not one per tensor: a train
    step is bound by its host launches)."""
    dist = _dist()
    if dist is None or not tensors:
        return tensors
    keys = list(tensors)
    flat = torch.cat([tensors[k].detach().float().reshape(-1) for k in keys])
    dist.all_reduce(flat)
    flat /= dist.get_world_size()
    out, lo = {}, 0
    for k in keys:
        t = tensors[k]
        out[k] = flat[lo: lo + t.numel()].view(t.shape).to(t.dtype)
        lo += t.numel()
    return out


class GlobalBatcher:
    """Host-batch -> this process's rows, for multi-process training.

    Every process iterates the SAME deterministic host batch stream (same
    files, same seed); ``shard`` keeps rows ``[r·B/N, (r+1)·B/N)`` of each
    leaf (``B`` the global batch, a multiple of ``N``). JAX's
    ``replicate`` has nothing to do here: every process already holds the
    same state."""

    def __init__(self, rank: int | None = None, world: int | None = None):
        self.rank = process_index() if rank is None else int(rank)
        self.world = process_count() if world is None else int(world)

    def rows(self, n: int) -> slice:
        if n % self.world:
            raise ValueError(f"a global batch of {n} rows does not split "
                             f"over {self.world} processes")
        per = n // self.world
        return slice(self.rank * per, (self.rank + 1) * per)

    def shard(self, tree):
        """Batch tree (leaves with a leading global-batch axis) -> this
        process's row slice of each leaf."""
        if isinstance(tree, dict):
            return {k: self.shard(v) for k, v in tree.items()}
        return tree[self.rows(len(tree))]


def tree_to_host(tree):
    """Tensor leaves -> host numpy (numpy leaves unchanged)."""
    if isinstance(tree, dict):
        return {k: tree_to_host(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree
