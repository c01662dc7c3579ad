"""The residual convs' share of their roofline in the traced training
steps: the least time the card needs for their forward, data-gradient,
weight-gradient and epilogue-backward work, over the device time of the
kernels that do it (``fused_conv_block``'s, ``conv_wgrad``'s and
``conv_epilogue_bwd``'s, by name, with their reduction passes).

Per residual conv and step, at N = 6 x the batch, L = the frame
positions it runs at, C = the filters, k taps, in the compute
precision (bytes e an element): the forward, the data gradient and the weight gradient each
``2 N L k C^2`` operations, moving two activations (input and output;
for the forward's second DYT conv three, the residual too) and the
weights; the epilogue backward moves ``dy``, the pre-norm ``u`` and
``du`` (the second conv also the residual and its gradient). Work the
kernels repeat (the recomputed DYT input) is not counted: it is the
implementation's, not the step's.
"""

from benchmark.harness.flops import residual_convs
from benchmark.harness.peaks import bound_s

LAYER = "kernels (ops/fused_conv.py, ops/fused_conv_grad.py, csrc/)"
UNIT = "%"
MOVES = "train_windows_per_s"
KERNELS = ("conv_bf16_wgmma", "conv_bf16_stream", "conv_f32_ring", "wgrad_bf16",
           "wgrad_f32", "reduce_splits", "conv_epilogue_bwd", "reduce_parts")
ELEM = {"bfloat16": 2, "float32": 4}


def step_bound_s(model_cfg: dict, batch: int, precision: str) -> float:
    n = 6 * batch
    e = ELEM[precision]
    total = 0.0
    for length, c, k, dyt, second in residual_convs(model_cfg):
        residual = dyt and second
        act = n * length * c * e
        weights = k * c * c * e
        flops = 2.0 * n * length * k * c * c
        total += bound_s(flops, (3 if residual else 2) * act + weights, precision)
        total += 2 * bound_s(flops, 2 * act + weights, precision)
        if dyt:
            total += bound_s(0.0, (5 if residual else 3) * act, precision)
    return total


def read(ctx):
    t, steps = ctx["trace"], ctx.get("traced_steps", 0)
    if t is None or not steps:
        return None
    secs, launches = t.kernel_seconds(KERNELS)
    if not launches or secs <= 0:
        return None
    bound = steps * step_bound_s(ctx["model_cfg"], ctx["batch"],
                                 ctx["settings"]["precision"])
    return 100.0 * bound / secs
