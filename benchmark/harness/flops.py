"""Model operations of one window's forward, counted from the
configuration's shapes.

Two operations for each multiply-add of every convolution, dense layer
and attention product, as the configuration states the model (the token
embedding is a lookup; elementwise work is not counted). A program that
folds or fuses layers does the same counted work.
"""

from __future__ import annotations

from benchmark.reference.model import _layers, crop_nt
from benchmark.reference.windows import frame_count


def residual_convs(model_cfg: dict) -> list[tuple[int, int, int, bool, bool]]:
    """``(L, C, k, in a DYT block, second conv)`` of each residual conv,
    ``L`` the frame positions it runs at (a VALID conv before it shortens
    them). The kernel adds the residual in a DYT block's second conv."""
    length = frame_count(crop_nt(model_cfg), crop_nt(model_cfg))
    out = []
    for name, cfg in _layers(model_cfg["representation_learner"]):
        if name == "masked_conv1d" and str(cfg.get("padding", "valid")).lower() != "same":
            length -= int(cfg["kernel_size"]) - 1
        elif name == "residual_block":
            c, k = int(cfg["filters"]), int(cfg.get("kernel_size", 3))
            dyt = cfg.get("norm_type", "masked_batchnorm") == "masked_dyt"
            for _ in range(int(cfg.get("block_size", 1))):
                out += [(length, c, k, dyt, False), (length, c, k, dyt, True)]
    return out


def forward_flops(model_cfg: dict, heads=("prediction", "reliability")) -> float:
    length = frame_count(crop_nt(model_cfg), crop_nt(model_cfg))
    tokens = 6 * length
    c = int(model_cfg["embedding"]["embedding_size"])
    flops = 0.0
    nmd = 0
    for name, cfg in _layers(model_cfg["representation_learner"]):
        if name == "masked_conv1d":
            k, f = int(cfg["kernel_size"]), int(cfg["filters"])
            if str(cfg.get("padding", "valid")).lower() != "same":
                length -= k - 1
                tokens = 6 * length
            flops += 2.0 * tokens * k * c * f
            c = f
        elif name == "residual_block":
            k, f = int(cfg.get("kernel_size", 3)), int(cfg["filters"])
            for _ in range(int(cfg.get("block_size", 1))):
                flops += 2.0 * tokens * k * (c * f + f * f)
                c = f
            nmd += c if cfg.get("return_nmd") else 0
        elif name == "cross_frame_attention":
            e, ff = int(cfg["embed_dim"]), int(cfg["feed_forward_dim"])
            flops += 2.0 * tokens * (3 * c * e + e * e + 2 * e * ff + 2 * 6 * e)
            c = e
        elif name == "nmd" or (name == "masked_batchnorm" and cfg.get("return_nmd")):
            nmd += c
    for head, width in (("classifier", c), ("reliability_model", nmd)):
        key = "prediction" if head == "classifier" else "reliability"
        for name, cfg in _layers(model_cfg.get(head)):
            if name == "dense":
                if key in heads:
                    flops += 2.0 * width * int(cfg["units"])
                width = int(cfg["units"])
    return flops
