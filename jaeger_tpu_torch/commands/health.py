"""Copy of `jaeger_tpu/commands/health.py`, on torch.

Install self-test: environment diagnostics, FASTA validation over the
bundled edge-case files, a device matmul, the device codon encode, and a
tiny model built -> saved -> reloaded -> run. The diagnostics name torch's
version, the CUDA device and whether the port's native host library is
built, where JAX's name its devices. The device checks run on ``device``
(``cuda`` by default): without CUDA they fail and ``health`` exits 1; it
does not move to the CPU unless ``device="cpu"`` asks for it.
"""

from __future__ import annotations

import tempfile
import traceback
from pathlib import Path

#: the JAX package's bundled edge-case FASTAs, read as data
TEST_DATA = Path(__file__).resolve().parents[2] / "jaeger_tpu" / "data" / "test"

_TINY_CONFIG = {
    "model": {
        "name": "health_tiny",
        "classifier_out_dim": 3,
        "class_label_map": [
            {"class": "chromosome", "label": 0},
            {"class": "phage", "label": 1},
            {"class": "plasmid", "label": 2},
        ],
        "embedding": {
            "use_embedding_layer": True,
            "input_type": "translated",
            "embedding_size": 8,
        },
        "string_processor": {"crop_size": 100, "seq_onehot": False},
        "representation_learner": {
            "hidden_layers": [
                {"name": "masked_conv1d",
                 "config": {"filters": 8, "kernel_size": 5}},
                {"name": "masked_batchnorm", "config": {}},
                {"name": "gelu"},
            ],
            "pooling": "average",
        },
        "classifier": {
            "hidden_layers": [{"name": "dense", "config": {"units": 3}}],
        },
    },
    "training": {},
}


def _print_diagnostics() -> None:
    """Environment diagnostics: versions, the CUDA device, the native
    library, host memory and the registered models."""
    import importlib
    import platform
    import sys

    import torch

    print("environment:")
    print(f"  python   : {sys.version.split()[0]} ({platform.platform()})")
    for mod in ("torch", "numpy", "pandas", "yaml", "msgpack"):
        try:
            version = getattr(importlib.import_module(mod), "__version__", "?")
            print(f"  {mod:<9}: {version}")
        except ImportError:
            print(f"  {mod:<9}: MISSING")
    if torch.cuda.is_available():
        print(f"  device   : {torch.cuda.get_device_name(0)} "
              f"(cuda {torch.version.cuda}, "
              f"{torch.cuda.device_count()} device(s))")
    else:
        print("  device   : no CUDA device")
    try:
        from jaeger_tpu_torch import native

        print(f"  native   : {'built' if native.available() else 'python fallback'}")
    except Exception as e:
        print(f"  native   : unavailable ({e})")
    try:
        import psutil

        mem = psutil.virtual_memory()
        print(f"  host mem : {mem.available / 2**30:.1f} / "
              f"{mem.total / 2**30:.1f} GB free")
    except ImportError:
        pass
    try:
        from jaeger_tpu_torch.utils.registry import AvailableModels

        models = AvailableModels()
        print(f"  models   : {sorted(models.info) or 'none registered'}")
    except Exception:
        pass


def tiny_roundtrip(path: str | Path, device=None, seed: int = 0):
    """Build the tiny model from seeded weights, save it to ``path`` with
    the port's ``save_model``, reload it on ``device`` and run it on four
    seeded windows of 305 nt -> (outputs, classes)."""
    import numpy as np
    import torch

    from jaeger_tpu_torch.models.artifacts import (init_params, load_model,
                                                   save_model)

    state = init_params(_TINY_CONFIG, torch.Generator().manual_seed(seed))
    save_model(state, _TINY_CONFIG, path)
    model, _config, classes = load_model(path, device=device)
    rng = np.random.default_rng(seed)
    bases = rng.integers(0, 4, size=(4, 305), dtype=np.uint8)
    lengths = np.full(4, 305, np.int32)
    dev = next(model.parameters()).device
    with torch.inference_mode():
        out = model(torch.from_numpy(bases).to(dev),
                    torch.from_numpy(lengths).to(dev))
    return out, classes


def health_core(device=None) -> int:
    failures = 0

    def check(name, fn):
        nonlocal failures
        try:
            detail = fn()
            print(f"  [ok] {name}" + (f": {detail}" if detail else ""))
        except Exception as e:
            failures += 1
            print(f"  [FAIL] {name}: {e}")
            traceback.print_exc(limit=2)

    print("jaeger-tpu health check")
    _print_diagnostics()

    def t_matmul():
        import torch

        from jaeger_tpu_torch.utils.devices import resolve_device

        dev = resolve_device(device)
        x = torch.ones((128, 128), device=dev)
        return f"matmul sum={float((x @ x).sum()):.0f} on {dev}"

    check("device matmul", t_matmul)

    def t_fasta():
        from jaeger_tpu_torch.seqops.fasta import (count_fasta,
                                                   validate_fasta_entries)

        results = []
        for name, min_len in [("test_contigs.fasta", 2048),
                              ("test_short.fasta", 2048),
                              ("test_empty.fasta", 2048)]:
            path = TEST_DATA / name
            if not path.exists():
                continue
            total, above = count_fasta(path, min_len)
            if name == "test_contigs.fasta":
                validate_fasta_entries(path, min_len)
            results.append(f"{name}:{above}/{total}")
        return " ".join(results)

    check("fasta validation", t_fasta)

    def t_encode():
        import torch

        from jaeger_tpu_torch.ops.encode import encode_frames
        from jaeger_tpu_torch.seqops.windows import windows_from_sequences
        from jaeger_tpu_torch.utils.devices import resolve_device

        dev = resolve_device(device)
        batch = windows_from_sequences(["ATGC" * 30], fragsize=120)
        toks = encode_frames(torch.from_numpy(batch.bases).to(dev),
                             torch.from_numpy(batch.length).to(dev),
                             crop_size=104)
        return f"tokens {tuple(toks.shape)}"

    check("device codon encode", t_encode)

    def t_roundtrip():
        with tempfile.TemporaryDirectory() as tmp:
            out, classes = tiny_roundtrip(tmp, device=device)
            assert tuple(out["prediction"].shape) == (4, 3)
            return f"classes={classes}"

    check("model save/load/predict round trip", t_roundtrip)

    print("health: " + ("OK" if failures == 0 else f"{failures} FAILURES"))
    return 1 if failures else 0
