"""Copy of `jaeger_tpu/models/flagship.py`: the inline configuration only.

A 1.2M-parameter 6-class fragment model with NMD-merge reliability: a k7
entry conv, DYT + NMD, three k5 DYT residual blocks, a max pool and a
1505 nt crop. The port never reads the reference tree, so
``flagship_config`` is always the inline one.
"""

from __future__ import annotations

_CLASSES = ["phage", "virus", "archaea", "bacteria", "plasmid", "eukarya"]


def _resblock(filters=128, kernel=5, nmd=True):
    entries = [
        {"name": "residual_block",
         "config": {"block_size": 1, "filters": filters,
                    "kernel_size": kernel, "norm_type": "masked_dyt"}},
        {"name": "masked_dyt", "config": {}},
    ]
    if nmd:
        entries.append({"name": "nmd", "config": {}})
    return entries


def _inline_flagship() -> dict:
    layers = [
        {"name": "masked_conv1d",
         "config": {"filters": 128, "kernel_size": 7}},
        {"name": "masked_dyt", "config": {}},
        {"name": "nmd", "config": {}},
    ]
    for _ in range(3):
        layers += _resblock()
    return {
        "model": {
            "name": "jaeger_tpu_flagship",
            "seed": 42,
            "classifier_out_dim": 6,
            "reliability_out_dim": 1,
            "class_label_map": [
                {"class": c, "label": i} for i, c in enumerate(_CLASSES)
            ],
            "embedding": {
                "use_embedding_layer": True,
                "input_type": "translated",
                "embedding_size": 196,
            },
            "string_processor": {"crop_size": 500, "seq_onehot": False},
            "representation_learner": {
                "hidden_layers": layers,
                "pooling": "max",
            },
            "reliability_model": {
                "mode": "nmd",
                "merge": {"mode": "concat"},
                "hidden_layers": [
                    {"name": "dropout", "config": {"rate": 0.1}},
                    {"name": "dense",
                     "config": {"units": 1, "dtype": "float32"}},
                ],
            },
            "classifier": {
                "hidden_layers": [
                    {"name": "dropout", "config": {"rate": 0.3}},
                    {"name": "dense",
                     "config": {"units": 6, "dtype": "float32"}},
                ],
            },
        },
        "training": {},
    }


def flagship_config() -> dict:
    return _inline_flagship()
