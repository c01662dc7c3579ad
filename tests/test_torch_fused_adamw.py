"""The fused Adam / AdamW update (``ops/fused_adamw.py``,
``csrc/fused_adamw.cu``) and ``Optimizer.apply``, on the CPU.

The kernel runs only on the card (``chip_smoke.py --adamw`` holds it
against the per-leaf update there). Here: which settings and tensors take
it; ``apply`` on CPU tensors is the per-leaf update; the leaf tables the
wrapper hands the C entry, cut at the parameter block's limit in flax
order; the C source's entry, layouts, constants and rounding; and the
kernels' arithmetic replayed in numpy on the tables themselves (reading
the tensors through the tables' addresses, the sums in the kernels'
orders), which must give the per-leaf update's bits wherever no clip
engages. Also the two counters, the benchmark's reader of them, and the
optimizer state restored beside the parameters' device.
"""

import copy
import ctypes
import importlib.util
import re
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from jaeger_tpu_torch.ops import fused_adamw as fa
from jaeger_tpu_torch.train import optimizers as topt
from jaeger_tpu_torch.utils import spans
from test_torch_train import OPT_CASES

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "jaeger_tpu_torch" / "csrc" / "fused_adamw.cu"
F32 = np.float32
THREADS = 256

ADAM_CASES = [c for c in OPT_CASES if c[0] in ("adam", "adamw")]


# ---------------------------------------------------------------------------
# the kernels' arithmetic on their own tables
# ---------------------------------------------------------------------------


def _view(addr: int, n: int) -> np.ndarray:
    """The n f32 values at ``addr`` (a CPU tensor's memory), writable."""
    return np.ctypeslib.as_array((ctypes.c_float * n).from_address(addr))


def _chunk_sumsq(g: np.ndarray) -> F32:
    """adamw_sumsq's sum for one chunk: thread t adds elements t, t + 256,
    ... in turn, a butterfly within each warp, the warps in order."""
    sq = np.zeros(-(-g.size // THREADS) * THREADS, F32)
    sq[:g.size] = g * g
    acc = np.zeros(THREADS, F32)
    for row in sq.reshape(-1, THREADS):
        acc = acc + row
    lanes = np.arange(THREADS)
    for off in (16, 8, 4, 2, 1):
        acc = acc + acc[lanes ^ off]
    total = acc[0]
    for w in range(1, THREADS // 32):
        total = F32(total + acc[32 * w])
    return total


def replay(t: fa.Table) -> None:
    """One table's launch pair (``jt_fused_adamw``), in numpy on the CPU
    tensors it points at."""
    slots = _view(t.partials, 2 * t.total_chunks).reshape(-1, 2)
    leaves = [t.leaf[i] for i in range(t.leaves)]
    for leaf in leaves:
        g = _view(leaf.g, leaf.n)
        for k in range(leaf.chunks):
            slots[leaf.chunk0 + k] = (
                _chunk_sumsq(g[k * fa.CHUNK:(k + 1) * fa.CHUNK]),
                k == leaf.chunks - 1)
    h = {name: F32(getattr(t, name)) for name in
         ("lr", "alpha", "b1", "c1", "b2", "c2", "eps", "wd", "clip")}
    for leaf in leaves:
        p, g, mu, nu = (_view(getattr(leaf, f), leaf.n)
                        for f in ("p", "g", "mu", "nu"))
        if t.flags & fa.FLAG_CLIP:
            ss = F32(0)
            for j in range(leaf.chunk0, leaf.chunk0 + leaf.chunks):
                ss = F32(ss + slots[j, 0])
            n = np.sqrt(ss)
            d = n if (np.isnan(n) or n > h["clip"]) else h["clip"]
            g = g * F32(F32(F32(1) / d) * h["clip"])
        m = mu * h["b1"] + g * h["c1"]
        v = nu * h["b2"] + (g * g) * h["c2"]
        u = (h["alpha"] * m) / (np.sqrt(v) + h["eps"])
        if t.flags & fa.FLAG_DECAY:
            u = u + p * h["wd"]
        mu[:], nu[:] = m, v
        p[:] = p + u * -h["lr"]
    if t.flags & fa.FLAG_NORM:
        total = acc = F32(0)
        for ss, last in slots[:t.total_chunks]:
            acc = F32(acc + ss)
            if last:
                total, acc = F32(total + acc), F32(0)
        _view(t.norm, 1)[0] = np.sqrt(total)


def replayed_fused_adamw_(keys, params, grads, mu, nu, **hyper):
    """``fused_adamw_`` on CPU tensors, its launches replayed."""
    leaves = [(params[k], grads[k].contiguous(), mu[k], nu[k]) for k in keys]
    total = fa.chunk_count(p.numel() for p, *_ in leaves)
    partials = torch.empty((total, 2), dtype=torch.float32)
    norm = torch.empty((), dtype=torch.float32)
    for t in fa.leaf_tables(leaves, partials=partials.data_ptr(),
                            norm=norm.data_ptr(), **hyper):
        replay(t)
    return norm


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

SHAPES = {"rep/conv/kernel": (5, 24, 40), "rep/conv/bias": (40,),
          "classifier/dense_0/kernel": (40, 3),
          "classifier/dense_0/bias": (3,), "embedding/embedding": (5, 4),
          "rep/norm/alpha": (1,)}


def _params(rng, shapes=SHAPES):
    return {k: torch.from_numpy(rng.normal(size=s).astype(np.float32))
            for k, s in shapes.items()}


def _grads(rng, params, scale):
    """Gradients whose every leaf has norm ``scale`` (0 for a frozen
    leaf, as the train step gives it)."""
    out = {}
    for k, p in params.items():
        g = rng.normal(size=p.shape).astype(np.float32)
        g *= scale / np.linalg.norm(g)
        out[k] = torch.from_numpy(g.astype(np.float32))
    out["embedding/embedding"] = torch.zeros(SHAPES["embedding/embedding"])
    return out


def _per_leaf(tx, params, grads, state):
    """The plain version: ``update``, the adds, ``global_norm``."""
    updates, state = tx.update(grads, state, params)
    return ({k: params[k] + updates[k] for k in params}, state,
            topt.global_norm(grads))


def _equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _scale_ulps(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest difference in ulps of the leaf's largest magnitude
    (elementwise ulps say nothing where a parameter or moment near zero
    took an update of the leaf's scale)."""
    scale = float(b.abs().max())
    diff = float((a - b).abs().max())
    return diff / float(np.spacing(F32(scale))) if scale else diff


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


def _like(device: str, dtype=torch.float32):
    return types.SimpleNamespace(is_cuda=device == "cuda", dtype=dtype)


@pytest.mark.parametrize("name,params,acc,leaves,fused", [
    ("adam", {"clipnorm": 1.0}, 1, [_like("cuda")] * 3, True),
    ("adamw", {"clipnorm": 1.0, "weight_decay": 1e-4}, 1,
     [_like("cuda")] * 3, True),
    ("adamw", {}, 1, [_like("cuda")], True),
    ("adamw", {"clipnorm": 1.0, "global_clipnorm": 0.7}, 1,
     [_like("cuda")], False),
    ("adam", {"clipnorm": 1.0}, 4, [_like("cuda")], False),
    ("muon", {}, 1, [_like("cuda")], False),
    ("sgd", {"momentum": 0.9}, 1, [_like("cuda")], False),
    ("rmsprop", {}, 1, [_like("cuda")], False),
    ("adagrad", {"clipnorm": 1.0}, 1, [_like("cuda")], False),
    ("adamw", {"clipnorm": 1.0}, 1, [_like("cpu")] * 2, False),
    ("adamw", {"clipnorm": 1.0}, 1, [_like("cuda"), _like("cpu")], False),
    ("adamw", {"clipnorm": 1.0}, 1, [_like("cuda", torch.bfloat16)], False),
    ("adamw", {"clipnorm": 1.0}, 1, [], False),
])
def test_dispatch_rule(name, params, acc, leaves, fused):
    """The kernel takes Adam and AdamW without accumulation or
    global_clipnorm on CUDA f32 parameters; nothing else."""
    tx = topt.make_optimizer(name, params, accumulation_steps=acc)
    assert tx.fuses({f"leaf{i}": p for i, p in enumerate(leaves)}) is fused


def test_cpu_tensors_take_the_per_leaf_update():
    tx = topt.make_optimizer("adamw", {"clipnorm": 1.0})
    p = _params(np.random.default_rng(0))
    assert not tx.fuses(p)
    with spans.recording():
        spans.reset()
        tx.apply(p, {k: torch.zeros_like(v) for k, v in p.items()},
                 tx.init(p))
        counters = spans.totals()["counters"]
    spans.reset()
    assert counters == {"optimizer/leaf_updates": 1}


def test_wrapper_refuses_what_the_kernels_do_not_take():
    p = {"w": torch.ones(4)}
    with pytest.raises(ValueError, match="CUDA"):
        fa.fused_adamw_(["w"], p, p, p, p, lr=1e-3, alpha=1.0, b1=0.9,
                        b2=0.999, eps=1e-7)
    dev = torch.device("cpu")
    base = torch.ones(4, 3)
    for bad in (base.t(), base.double(), torch.ones(3, 4)):
        with pytest.raises(ValueError):
            fa._leaf("w", base, base, bad, base, dev)
    with pytest.raises(ValueError):
        fa._leaf("w", base.t(), base.t(), base.t(), base.t(), dev)
    # only the gradient may come non-contiguous: it is copied
    g = torch.ones(3, 4).t()
    _, got, _, _ = fa._leaf("w", base, g, base, base, dev)
    assert got.is_contiguous() and torch.equal(got, g)


# ---------------------------------------------------------------------------
# apply on the CPU is the per-leaf update
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,params,acc", ADAM_CASES)
def test_apply_on_cpu_is_the_per_leaf_update(name, params, acc):
    """Three steps, a set_learning_rate between the second and the third:
    the parameters, mu, nu and count bitwise those of update + add_, the
    norm that of global_norm."""
    rng = np.random.default_rng(7)
    tx = topt.make_optimizer(name, copy.deepcopy(params),
                             accumulation_steps=acc)
    p_apply = _params(rng)
    p_plain = {k: v.clone() for k, v in p_apply.items()}
    s_apply, s_plain = tx.init(p_apply), tx.init(p_plain)
    for step in range(3):
        g = _grads(rng, p_apply, 0.3 + step)
        p_plain, s_plain, n_plain = _per_leaf(tx, p_plain, g, s_plain)
        s_apply, n_apply = tx.apply(p_apply, g, s_apply)
        _equal(p_apply, p_plain)
        assert torch.equal(n_apply, n_plain)
        assert torch.equal(s_apply["count"], s_plain["count"])
        for moment in ("mu", "nu"):
            if moment in s_plain:
                _equal(s_apply[moment], s_plain[moment])
        if step == 1:
            s_apply = topt.set_learning_rate(s_apply, 0.004)
            s_plain = topt.set_learning_rate(s_plain, 0.004)


# ---------------------------------------------------------------------------
# the kernels' tables and arithmetic
# ---------------------------------------------------------------------------


def _run_both(tx, shapes, scale, steps=3, seed=3):
    """Per-leaf update and the replayed fused path from the same start:
    (per-leaf params, state, norms), (fused params, state, norms)."""
    rng = np.random.default_rng(seed)
    p_fused = _params(rng, shapes)
    p_plain = {k: v.clone() for k, v in p_fused.items()}
    s_fused, s_plain = tx.init(p_fused), tx.init(p_plain)
    n_fused, n_plain = [], []
    for step in range(steps):
        g = {k: torch.from_numpy((rng.normal(size=v.shape) * scale)
                                 .astype(np.float32))
             for k, v in p_fused.items()}
        p_plain, s_plain, n = _per_leaf(tx, p_plain, g, s_plain)
        n_plain.append(n)
        s_fused, n = tx._apply_fused(p_fused, g, s_fused)
        n_fused.append(n)
        if step == 0:
            s_fused = topt.set_learning_rate(s_fused, 5e-4)
            s_plain = topt.set_learning_rate(s_plain, 5e-4)
    return (p_plain, s_plain, n_plain), (p_fused, s_fused, n_fused)


_TORCH_SQRT = torch.sqrt


def _rounded_sqrt(x):
    """torch.sqrt correctly rounded in f32 on the CPU, as it is on the card
    and in the kernel (PyTorch's vectorized CPU sqrt is off by an ulp on
    some inputs)."""
    if x.dtype == torch.float32 and x.device.type == "cpu":
        return torch.from_numpy(np.asarray(np.sqrt(x.contiguous().numpy())))
    return _TORCH_SQRT(x)


@pytest.fixture
def replayed(monkeypatch):
    """``fused_adamw_`` replayed on the CPU, and the per-leaf update's
    square roots rounded as the card rounds them."""
    monkeypatch.setattr(fa, "fused_adamw_", replayed_fused_adamw_)
    monkeypatch.setattr(torch, "sqrt", _rounded_sqrt)


@pytest.mark.parametrize("name,params", [
    ("adamw", {"learning_rate": 1e-3, "weight_decay": 1e-4,
               "clipnorm": 1e6}),
    ("adam", {"learning_rate": 0.01}),
    ("adamw", {"learning_rate": {"initial_learning_rate": 0.02,
                                 "decay_steps": 4, "warmup_steps": 1,
                                 "alpha": 0.1}, "clipnorm": 0.7}),
])
def test_kernel_arithmetic_is_the_per_leaf_update(replayed, name, params):
    """Where no leaf's norm passes the clip norm (or none is set) the
    kernels' arithmetic gives the per-leaf update's bits; the norm, added
    in another order than torch.sum's, within 1e-6."""
    tx = topt.make_optimizer(name, copy.deepcopy(params))
    scale = 1e-3 if "clipnorm" in params else 0.5
    (p_plain, s_plain, n_plain), (p_fused, s_fused, n_fused) = _run_both(
        tx, SHAPES, scale)
    _equal(p_fused, p_plain)
    _equal(s_fused["mu"], s_plain["mu"])
    _equal(s_fused["nu"], s_plain["nu"])
    assert torch.equal(s_fused["count"], s_plain["count"])
    for a, b in zip(n_fused, n_plain):
        assert abs(float(a) - float(b)) <= 1e-6 * float(b)


def test_kernel_arithmetic_where_the_clip_engages(replayed):
    """The large leaves clipped: within 4 ulps of each leaf's largest
    magnitude of the per-leaf update (the clip factor's sum of squares is
    added in another order than torch.sum's)."""
    tx = topt.make_optimizer("adamw", {"learning_rate": 1e-3,
                                       "clipnorm": 1.0})
    (p_plain, s_plain, _), (p_fused, s_fused, _) = _run_both(tx, SHAPES, 3.0)
    assert not torch.equal(s_fused["mu"]["rep/conv/kernel"],
                           s_plain["mu"]["rep/conv/kernel"])
    for k in p_plain:
        assert _scale_ulps(p_fused[k], p_plain[k]) <= 4, k
        assert _scale_ulps(s_fused["mu"][k], s_plain["mu"][k]) <= 4, k
        assert _scale_ulps(s_fused["nu"][k], s_plain["nu"][k]) <= 4, k


def test_fused_state_keeps_its_keys_and_tensors(replayed, monkeypatch):
    """apply on the fused path: mu and nu are the dicts and tensors init
    made, updated in place; count moves on; one fused update counted a
    step."""
    monkeypatch.setattr(topt.Optimizer, "fuses", lambda self, params: True)
    tx = topt.make_optimizer("adamw", {"clipnorm": 1.0})
    rng = np.random.default_rng(5)
    p = _params(rng)
    state = tx.init(p)
    mu, nu = state["mu"], state["nu"]
    tensors = {k: (mu[k], nu[k], mu[k].data_ptr()) for k in mu}
    spans.reset()
    with spans.recording():
        for step in range(3):
            state, norm = tx.apply(p, _grads(rng, p, 0.5), state)
            assert state["mu"] is mu and state["nu"] is nu
            assert list(mu) == list(p) and list(nu) == list(p)
            assert all(mu[k] is m and nu[k] is v and mu[k].data_ptr() == a
                       for k, (m, v, a) in tensors.items())
            assert int(state["count"]) == step + 1
            assert state["count"].device.type == "cpu"
            assert norm.shape == () and norm.dtype == torch.float32
        assert spans.totals()["counters"] == {"optimizer/fused_updates": 3}
    spans.reset()
    assert all(bool((m != 0).any()) for k, m in mu.items()
               if k != "embedding/embedding")


def _many_shapes(n: int) -> dict:
    """n leaves of mixed sizes (some of several chunks, some empty), keyed
    so that flax order differs from insertion order."""
    sizes = [1, 7, fa.CHUNK, fa.CHUNK + 1, 3 * fa.CHUNK - 5, 0, 300]
    return {f"layer_{(37 * i) % n:03d}/w": (sizes[i % len(sizes)],)
            for i in range(n)}


@pytest.mark.parametrize("n_leaves", [1, fa.MAX_LEAVES, fa.MAX_LEAVES + 1,
                                      200])
def test_tables_cut_at_the_parameter_block(n_leaves):
    """The non-empty leaves in flax order, at most MAX_LEAVES a table, the
    chunks contiguous across the tables, the norm written by the last;
    the table fits the 4 KB parameter block."""
    assert ctypes.sizeof(fa.Table) <= 4096
    assert ctypes.sizeof(fa.Leaf) == 48
    rng = np.random.default_rng(1)
    shapes = _many_shapes(n_leaves)
    keys = topt.flax_order(shapes)
    tensors = {k: torch.from_numpy(rng.normal(size=s).astype(np.float32))
               for k, s in shapes.items()}
    leaves = [(tensors[k],) * 4 for k in keys]
    tables = fa.leaf_tables(leaves, lr=1e-3, alpha=1.0, b1=0.9, b2=0.999,
                            eps=1e-7, partials=16, norm=32)
    live = [k for k in keys if tensors[k].numel()]
    assert len(tables) == -(-len(live) // fa.MAX_LEAVES)
    got, chunk = [], 0
    for i, t in enumerate(tables):
        assert 1 <= t.leaves <= fa.MAX_LEAVES and t.chunk0 == chunk
        assert bool(t.flags & fa.FLAG_NORM) == (i == len(tables) - 1)
        for j in range(t.leaves):
            leaf = t.leaf[j]
            got.append(leaf.p)
            assert leaf.chunk0 == chunk
            assert leaf.chunks == -(-leaf.n // fa.CHUNK)
            chunk += leaf.chunks
        assert t.chunks == chunk - t.chunk0
    assert got == [tensors[k].data_ptr() for k in live]
    assert all(t.total_chunks == chunk for t in tables)
    assert fa.leaf_groups([3, 0, 5]) == [[0, 2]]


@pytest.mark.parametrize("n_leaves", [fa.MAX_LEAVES + 1, 200])
def test_several_tables_give_the_per_leaf_update(replayed, n_leaves):
    tx = topt.make_optimizer("adamw", {"learning_rate": 1e-3,
                                       "clipnorm": 1e4})
    shapes = {k: s for k, s in _many_shapes(n_leaves).items()}
    (p_plain, s_plain, n_plain), (p_fused, s_fused, n_fused) = _run_both(
        tx, shapes, 0.01, steps=2)
    _equal(p_fused, p_plain)
    _equal(s_fused["mu"], s_plain["mu"])
    _equal(s_fused["nu"], s_plain["nu"])
    for a, b in zip(n_fused, n_plain):
        assert abs(float(a) - float(b)) <= 1e-6 * float(b)


def test_replayed_kernels_give_the_same_bits_twice(replayed):
    tx = topt.make_optimizer("adamw", {"clipnorm": 1.0})
    runs = [_run_both(tx, SHAPES, 2.0, seed=11)[1] for _ in range(2)]
    _equal(runs[0][0], runs[1][0])
    assert [float(n) for n in runs[0][2]] == [float(n) for n in runs[1][2]]


# ---------------------------------------------------------------------------
# the C source
# ---------------------------------------------------------------------------


def _c_kinds(src: str, entry: str) -> list:
    proto = re.search(rf'extern "C" int {entry}\((.*?)\)', src,
                      re.S).group(1)
    return [ctypes.c_void_p if ("*" in a or "stream" in a) else ctypes.c_int
            for a in proto.split(",")]


def _c_fields(src: str, struct: str) -> list[str]:
    body = re.search(rf"struct {struct} \{{(.*?)\n\}};", src, re.S).group(1)
    return re.findall(r"\b(\w+)(?:\[\w+\])?;", body)


def test_source_declares_entry_layout_and_rounding():
    src = SRC.read_text()
    assert _c_kinds(src, "jt_fused_adamw") == fa.ARGTYPES
    assert "jt_fused_adamw_table_bytes()" in src
    assert _c_fields(src, "Leaf") == [f for f, _ in fa.Leaf._fields_]
    assert _c_fields(src, "Table") == [f for f, _ in fa.Table._fields_]
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert int(consts["CHUNK"]) == fa.CHUNK
    assert int(consts["MAX_LEAVES"]) == fa.MAX_LEAVES
    assert (int(consts["FLAG_CLIP"]), int(consts["FLAG_DECAY"]),
            int(consts["FLAG_NORM"])) == (fa.FLAG_CLIP, fa.FLAG_DECAY,
                                          fa.FLAG_NORM)
    assert "__grid_constant__" in src
    for op in ("__fmul_rn", "__fadd_rn", "__fdiv_rn", "__fsqrt_rn"):
        assert op in src
    # the kernels' arithmetic: every float product, sum, quotient and root
    # an intrinsic that is never contracted into an FMA
    kernels = src[src.index("__global__"):src.index('extern "C"')]
    assert not re.search(r"\bfmaf?\(|__fmaf|sqrtf\(|rsqrtf|atomicAdd",
                         kernels)
    assert "jaeger_tpu/train/optimizers.py" in src


# ---------------------------------------------------------------------------
# the counters and the benchmark's reader
# ---------------------------------------------------------------------------


def _reader():
    path = ROOT / "benchmark" / "metrics" / "optimizer_fused_share.train.py"
    spec = importlib.util.spec_from_file_location("fused_share_reader", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_counters_are_named_and_read(monkeypatch):
    assert {"optimizer/fused_updates",
            "optimizer/leaf_updates"} <= spans.NAMES
    reader = _reader()
    assert (reader.UNIT, reader.MOVES) == ("%", "train_windows_per_s")
    spans.reset()
    assert reader.read({}) is None
    monkeypatch.setattr(spans, "totals", lambda: {
        "spans": {}, "counters": {"optimizer/fused_updates": 6,
                                  "optimizer/leaf_updates": 2}})
    assert reader.read({}) == 75.0


def test_reader_of_a_program_without_the_counters_reads_nothing(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaeger_tpu_torch.utils.spans", None)
    assert _reader().read({}) is None


# ---------------------------------------------------------------------------
# the state restored beside the parameters
# ---------------------------------------------------------------------------


def test_restored_state_keeps_each_tensor_s_device(tmp_path):
    """A checkpoint's optimizer state comes back with the count and the
    learning rate on the CPU and the moments where the template keeps
    them (the meta device standing in for the card)."""
    from jaeger_tpu_torch.train.checkpoint import CheckpointManager

    tx = topt.make_optimizer("adamw", {"clipnorm": 1.0})
    p = _params(np.random.default_rng(2))
    saved = tx.init(p)
    saved["mu"] = {k: v + 1.0 for k, v in saved["mu"].items()}
    mgr = CheckpointManager(tmp_path / "ckpt")
    mgr.save(1, {"w": torch.ones(2)}, opt_state=saved)
    template = tx.init(p)
    template["mu"] = {k: v.to("meta") for k, v in template["mu"].items()}
    got = mgr.restore_opt_state(mgr.latest(), template)
    assert got["count"].device.type == "cpu"
    assert got["learning_rate"].device.type == "cpu"
    assert all(v.device.type == "meta" for v in got["mu"].values())
    _equal(got["nu"], saved["nu"])
