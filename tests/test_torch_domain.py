"""``fused_conv_block`` on the whole domain of its Pallas kernel, on the CPU.

The Pallas kernel (``jaeger_tpu/ops/pallas_conv.py``) takes any channel
count C and tap count k, bf16 or f32. The port's ``conv_plan`` gives every
(C, k, dtype) a plan: the shapes the resident bf16 kernel cannot hold (C %
16 != 0, k > 56, weights and two x stages past shared memory) take route
``wgmma_stream``; f32 takes ``f32_ring`` at every C % 16 == 0 and
``f32_ring_pad`` (channels padded to 16, or weights streamed in channel
groups) otherwise. Covered, with the tolerances of
``tests/test_pallas_conv.py`` (2e-4 in f32, 5e-2 in bf16) and of
``tests/test_torch_templates.py`` (1e-5 of each output's scale, gradients
5e-5):

* the plain version (the CPU twin of every route) against the Pallas
  kernel in interpret mode at the new shapes;
* a plan for every (C, k) of a grid in both dtypes, its shared memory
  within the card's and equal to its layout function's bytes;
* the plans of the shapes the kernel took before, frozen, equal key for
  key;
* a flagship with 200 channels: its forward equal to JAX's; one f32 train
  step of a C 192, k 3 model (now on the fused path, data gradient and
  ``conv_wgrad`` included) equal to JAX's; a C 40 model's ``run_core``
  TSV byte-identical to JAX's.
"""

import copy

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from jaeger_tpu.models.builder import ModelBuilder
from jaeger_tpu.ops.pallas_conv import fused_conv_block as jax_fused
from jaeger_tpu_torch.models import layers as TL
from jaeger_tpu_torch.models.artifacts import params_from_jax, save_model
from jaeger_tpu_torch.models.builder import build_model
from jaeger_tpu_torch.models.flagship import flagship_config
from jaeger_tpu_torch.ops import fused_conv
from test_torch_route import _residual_config
from test_torch_templates import (FASTA, _bases, _check_step,
                                  _forward_matches_jax, _variables)

BF16, F32 = torch.bfloat16, torch.float32

#: (C, k, dtype) against the Pallas kernel: channel counts off 16 and off
#: 8, past the resident layouts' columns, k past the bf16 in_mask word,
#: f32 past the old C <= 128 or C % 128 == 0 rule, an even k
PALLAS_DOMAIN = [(c, 3, dt) for c in (24, 37, 40) for dt in ("bfloat16",
                                                            "float32")]
PALLAS_DOMAIN += [(200, 5, "bfloat16"), (200, 5, "float32"),
                  (128, 61, "bfloat16"), (144, 3, "float32"),
                  (192, 3, "float32"), (40, 4, "bfloat16"),
                  (40, 4, "float32")]


@pytest.mark.parametrize("c,k,dt", PALLAS_DOMAIN)
def test_plain_version_matches_pallas_kernel(rng, c, k, dt):
    """DYT + gelu: the plain version (and the wrapper on CPU tensors)
    against the Pallas kernel in interpret mode."""
    n, length = 2, 70
    x = rng.normal(size=(n, length, c)).astype(np.float32)
    w = (rng.normal(size=(k, c, c)) * 0.05).astype(np.float32)
    dyt = np.stack([np.full(c, 0.5, np.float32),
                    rng.normal(size=c).astype(np.float32),
                    rng.normal(size=c).astype(np.float32)])
    jdt = jnp.bfloat16 if dt == "bfloat16" else jnp.float32
    tdt = getattr(torch, dt)
    pallas = jax_fused(jnp.asarray(x).astype(jdt), jnp.asarray(w),
                       dyt=jnp.asarray(dyt), act="gelu", use_dyt=True,
                       interpret=True, tile_n=2, tile_l=32)
    tx = torch.from_numpy(x).to(tdt)
    got = fused_conv.fused_conv_block(tx, torch.from_numpy(w),
                                      dyt=torch.from_numpy(dyt), act="gelu",
                                      use_dyt=True)
    twin = fused_conv.reference_conv_block(
        tx, torch.from_numpy(w), dyt=torch.from_numpy(dyt), act="gelu",
        use_dyt=True)
    assert got.dtype == tdt and torch.equal(got, twin)
    tol = 5e-2 if dt == "bfloat16" else 2e-4
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(pallas, np.float32), rtol=tol,
                               atol=tol)


GRID_KS = (1, 2, 3, 5, 7, 9, 10, 11, 31, 56, 57, 64, 129)
GRID_CS = (1, 16, 37, 40, 128, 200, 1024)


def _grid(part: int, parts: int) -> list[tuple[int, int]]:
    """Every C from 1 to 1100 at ``GRID_KS`` and every k from 1 to 129 at
    ``GRID_CS``; the ``part``-th of ``parts`` slices by C."""
    shapes = {(c, k) for c in range(1, 1101) for k in GRID_KS}
    shapes |= {(c, k) for k in range(1, 130) for c in GRID_CS}
    return sorted(s for s in shapes if s[0] % parts == part)


def _layout_bytes(c: int, k: int, plan: dict) -> int:
    """The bytes of the layout that ``plan``'s route launches."""
    route = plan.get("route", "wgmma")
    if route == "wgmma":
        assert c % plan["cb"] == 0 and c % plan["kw"] == 0
        return fused_conv.plan_bytes(c, k, plan["cb"], plan["kw"],
                                     plan["stages"])
    if route == "wgmma_stream":
        assert plan["cb"] in fused_conv.STREAM_WIDTHS
        assert plan["kw"] == fused_conv.STREAM_KW
        assert 1 <= plan["taps"] <= min(k, fused_conv.STREAM_MAX_TAPS)
        # one column block up to 256 channels, else blocks of at most 256
        assert -(-c // plan["cb"]) == -(-c // 256)
        steps = k * -(-c // fused_conv.STREAM_KW)
        resident = plan["wstages"] >= steps
        assert resident or 2 <= plan["wstages"] <= 8
        # multicast only of streamed weights copied by TMA (C % 8 == 0),
        # where their rows are not 128-byte aligned (C % 64 != 0)
        assert plan["cluster"] == (1 if resident or c % 8 or c % 64 == 0
                                   else 2)
        return fused_conv.stream_plan_bytes(plan["cb"], plan["taps"],
                                            plan["stages"], plan["wstages"])
    assert route == ("f32_ring" if c % 16 == 0 and not plan["kw"]
                     else "f32_ring_pad")
    cp = -(-c // 16) * 16
    assert cp % plan["cb"] == 0 and plan["kw"] % 16 == 0
    assert plan["kw"] < cp and 1 <= plan["taps"] <= k
    return fused_conv.f32_plan_bytes(c, k, plan["cb"], plan["stages"],
                                     plan["taps"], plan["kw"])


@pytest.mark.parametrize("part", range(4))
@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
def test_every_shape_has_a_plan(dtype, part):
    for c, k in _grid(part, 4):
        plan = fused_conv.conv_plan(c, k, dtype)
        assert 2 <= plan["stages"] <= 4, (c, k, plan)
        assert plan["smem"] <= fused_conv.SMEM_LIMIT, (c, k, plan)
        assert plan["smem"] == _layout_bytes(c, k, plan), (c, k, plan)


@pytest.mark.parametrize("c,k,dtype", [(0, 3, BF16), (16, 0, BF16),
                                       (0, 3, F32), (16, 0, F32)])
def test_plan_refuses_no_channels_or_taps(c, k, dtype):
    with pytest.raises(ValueError):
        fused_conv.conv_plan(c, k, dtype)


def test_channel_groups_past_one_tap_of_weights():
    """f32 past about 1,560 channels: one tap of Cp x 16 weights does not
    fit, so the weights stream in groups of ``kw`` channels."""
    for c, k in ((1990, 4), (2048, 3), (4099, 2), (5000, 200)):
        plan = fused_conv.conv_plan(c, k, F32)
        assert plan["route"] == "f32_ring_pad" and plan["kw"] >= 16, plan
        assert plan["smem"] == _layout_bytes(c, k, plan)


#: d4247dd's plans of the grid's shapes that it took: bf16 "C k cb kw
#: stages smem", f32 "C k cb taps stages smem" (route f32_ring, kw 0,
#: tile 32)
FROZEN_BF16 = """
16 1 16 16 4 10560;16 2 16 16 4 14656;16 3 16 16 4 15680;
16 4 16 16 4 15680;16 5 16 16 4 16704;16 6 16 16 4 16704;
16 7 16 16 4 17728;16 8 16 16 4 17728;16 9 16 16 4 18752;
16 10 16 16 4 18752;16 11 16 16 4 19776;16 12 16 16 4 19776;
16 13 16 16 4 20800;16 14 16 16 4 20800;16 15 16 16 4 21824;
16 16 16 16 4 21824;16 17 16 16 4 22848;16 18 16 16 4 22848;
16 19 16 16 4 23872;16 20 16 16 4 23872;16 21 16 16 4 24896;
16 22 16 16 4 24896;16 23 16 16 4 25920;16 24 16 16 4 25920;
16 25 16 16 4 26944;16 26 16 16 4 26944;16 27 16 16 4 27968;
16 28 16 16 4 27968;16 29 16 16 4 28992;16 30 16 16 4 28992;
16 31 16 16 4 30016;16 32 16 16 4 30016;16 33 16 16 4 31040;
16 34 16 16 4 35136;16 35 16 16 4 36160;16 36 16 16 4 36160;
16 37 16 16 4 37184;16 38 16 16 4 37184;16 39 16 16 4 38208;
16 40 16 16 4 38208;16 41 16 16 4 39232;16 42 16 16 4 39232;
16 43 16 16 4 40256;16 44 16 16 4 40256;16 45 16 16 4 41280;
16 46 16 16 4 41280;16 47 16 16 4 42304;16 48 16 16 4 42304;
16 49 16 16 4 43328;16 50 16 16 4 43328;16 51 16 16 4 44352;
16 52 16 16 4 44352;16 53 16 16 4 45376;16 54 16 16 4 45376;
16 55 16 16 4 46400;16 56 16 16 4 46400;32 1 32 32 4 20032;
32 2 32 32 4 26176;32 3 32 32 4 28224;32 5 32 32 4 32320;
32 7 32 32 4 36416;32 9 32 32 4 40512;32 10 32 32 4 42560;
32 11 32 32 4 44608;32 31 32 32 4 89664;32 56 32 32 4 149056;
48 1 16 16 4 27968;48 2 16 16 4 41280;48 3 16 16 4 43328;
48 5 16 16 4 46400;48 7 16 16 4 49472;48 9 16 16 4 52544;
48 10 16 16 4 53568;48 11 16 16 4 55616;48 31 16 16 4 86336;
48 56 16 16 4 136512;64 1 64 64 4 43072;64 2 64 64 4 55360;
64 3 64 64 4 63552;64 5 64 64 4 79936;64 7 64 64 4 96320;
64 9 64 64 4 112704;64 10 64 64 4 124992;64 11 64 64 4 133184;
64 31 32 64 4 177728;64 56 16 64 4 177472;80 1 16 16 4 45376;
80 2 16 16 4 67904;80 3 16 16 4 70976;80 5 16 16 4 76096;
80 7 16 16 4 81216;80 9 16 16 4 86336;80 10 16 16 4 88384;
80 11 16 16 4 91456;80 31 16 16 4 142656;80 56 16 16 4 226624;
96 1 32 32 4 56896;96 2 32 32 4 75328;96 3 32 32 4 81472;
96 5 32 32 4 93760;96 7 32 32 4 106048;96 9 32 32 4 118336;
96 10 32 32 4 124480;96 11 32 32 4 130624;96 31 32 32 2 228896;
96 56 16 32 2 222496;112 1 16 16 4 62784;112 2 16 16 4 94528;
112 3 16 16 4 98624;112 5 16 16 4 105792;112 7 16 16 4 112960;
112 9 16 16 4 120128;112 10 16 16 4 123200;112 11 16 16 4 127296;
112 31 16 16 4 198976;128 1 128 64 4 101440;128 2 128 64 4 142400;
128 3 128 64 4 175168;128 4 128 64 4 207936;128 5 128 64 3 222256;
128 6 64 64 4 174144;128 7 64 64 4 190528;128 8 64 64 4 206912;
128 9 64 64 4 223296;128 10 64 64 3 227376;128 11 64 64 2 223264;
128 12 32 64 4 181824;128 13 32 64 4 190016;128 14 32 64 4 198208;
128 15 32 64 4 206400;128 16 32 64 4 214592;128 17 32 64 4 222784;
128 18 32 64 3 216624;128 19 32 64 3 224816;128 20 32 64 2 210464;
128 21 32 64 2 218656;128 22 32 64 2 226848;128 23 16 64 4 185664;
128 24 16 64 4 189760;128 25 16 64 4 193856;128 26 16 64 4 206144;
128 27 16 64 4 210240;128 28 16 64 4 214336;128 29 16 64 4 218432;
128 30 16 64 4 222528;128 31 16 64 4 226624;128 32 16 64 4 230720;
128 33 16 64 3 210224;128 34 16 64 3 220464;128 35 16 64 3 224560;
128 36 16 64 3 228656;128 37 16 64 2 206112;128 38 16 64 2 210208;
128 39 16 64 2 214304;128 40 16 64 2 218400;128 41 16 64 2 222496;
128 42 16 64 2 230688;144 1 16 16 4 80192;144 2 16 16 4 121152;
144 3 16 16 4 126272;144 5 16 16 4 135488;144 7 16 16 4 144704;
144 9 16 16 4 153920;144 10 16 16 4 158016;144 11 16 16 4 163136;
144 31 16 16 3 227632;160 1 32 32 4 93760;160 2 32 32 4 124480;
160 3 32 32 4 134720;160 5 32 32 4 155200;160 7 32 32 4 175680;
160 9 32 32 4 196160;160 10 32 32 4 206400;160 11 32 32 4 216640;
160 31 16 32 2 221472;176 1 16 16 4 97600;176 2 16 16 4 147776;
176 3 16 16 4 153920;176 5 16 16 4 165184;176 7 16 16 4 176448;
176 9 16 16 4 187712;176 10 16 16 4 192832;176 11 16 16 4 198976;
192 1 64 64 4 124992;192 2 64 64 4 161856;192 3 64 64 4 186432;
192 5 64 64 3 207920;192 7 64 64 2 229408;192 9 32 64 4 222784;
192 10 32 64 3 216624;192 11 32 64 3 228912;208 1 16 16 4 115008;
208 2 16 16 4 174400;208 3 16 16 4 181568;208 5 16 16 4 194880;
208 7 16 16 4 208192;208 9 16 16 4 221504;208 10 16 16 4 227648;
208 11 16 16 3 194864;224 1 32 32 4 130624;224 2 32 32 4 173632;
224 3 32 32 4 187968;224 5 32 32 4 216640;224 7 32 32 3 209456;
224 9 32 32 2 202272;224 10 32 32 2 216608;224 11 32 32 2 230944;
240 1 16 16 4 132416;240 2 16 16 4 201024;240 3 16 16 4 209216;
240 5 16 16 4 224576;240 7 16 16 3 193840;240 9 16 16 3 209200;
240 10 16 16 3 216368;240 11 16 16 3 224560;256 1 128 64 4 199744;
256 2 128 64 2 207904;256 3 64 64 3 210992;256 5 32 64 4 230976;
256 7 32 64 3 226864;256 9 32 64 2 222752;256 10 16 64 3 206128;
256 11 16 64 3 214320;272 1 16 16 4 149824;272 2 16 16 4 227648;
272 3 16 16 3 184624;272 5 16 16 3 202032;272 7 16 16 3 219440;
272 9 16 16 2 184608;272 10 16 16 2 192800;272 11 16 16 2 202016;
288 1 32 32 4 167488;288 2 32 32 4 222784;288 3 32 32 3 195120;
288 5 32 32 3 231984;288 7 32 32 2 222752;288 9 16 32 3 222512;
288 10 16 32 3 231728;288 11 16 32 2 194848;304 1 16 16 4 167232;
304 2 16 16 3 195888;304 3 16 16 3 206128;304 5 16 16 3 225584;
304 7 16 16 2 186656;304 9 16 16 2 206112;304 10 16 16 2 215328;
304 11 16 16 2 225568;320 1 64 64 4 206912;320 2 64 64 3 222256;
320 3 64 64 2 217120;320 5 32 64 2 196128;320 7 16 64 3 211248;
320 9 16 64 3 231728;320 10 16 64 2 206112;320 11 16 64 2 216352;
336 1 16 16 4 184640;336 2 16 16 3 216368;336 3 16 16 3 227632;
336 5 16 16 2 184608;336 7 16 16 2 206112;336 9 16 16 2 227616;
352 1 32 32 4 204352;352 2 32 32 3 215600;352 3 32 32 2 181792;
352 5 32 32 2 226848;352 7 16 32 2 192800;352 9 16 32 2 215328;
352 10 16 32 2 226592;368 1 16 16 4 202048;368 2 16 16 2 166176;
368 3 16 16 2 178464;368 5 16 16 2 202016;368 7 16 16 2 225568;
384 1 128 64 2 199712;384 2 64 64 2 210976;384 3 32 64 2 185888;
384 5 16 64 3 228656;384 7 16 64 2 197920;384 9 16 64 2 222496;
400 1 16 16 4 219456;400 2 16 16 2 180512;400 3 16 16 2 193824;
400 5 16 16 2 219424;416 1 32 32 3 187952;416 2 32 32 2 187936;
416 3 32 32 2 214560;416 5 16 32 2 200992;416 7 16 32 2 227616;
432 1 16 16 3 181552;432 2 16 16 2 194848;432 3 16 16 2 209184;
448 1 64 64 3 231472;448 2 32 64 2 187936;448 3 32 64 2 216608;
448 5 16 64 2 202016;448 7 16 64 2 230688;464 1 16 16 3 194864;
464 2 16 16 2 209184;464 3 16 16 2 224544;480 1 32 32 3 216624;
480 2 32 32 2 216608;480 3 16 32 2 200992;480 5 16 32 2 231712;
496 1 16 16 3 208176;496 2 16 16 2 223520;512 1 64 64 2 198688;
512 2 32 64 2 214560;512 3 16 64 2 197920;512 5 16 64 2 230688;
528 1 16 16 3 221488;544 1 32 32 2 175648;544 2 16 32 2 210208;
544 3 16 32 2 227616;560 1 16 16 2 163104;576 1 64 64 2 223264;
576 2 16 64 2 204064;576 3 16 64 2 222496;592 1 16 16 2 172320;
608 1 32 32 2 196128;624 1 16 16 2 181536;640 1 32 64 2 206368;
640 2 16 64 2 226592;656 1 16 16 2 190752;672 1 32 32 2 216608;
688 1 16 16 2 199968;704 1 32 64 2 226848;720 1 16 16 2 209184;
736 1 16 32 2 213280;752 1 16 16 2 218400;768 1 16 64 2 222496;
784 1 16 16 2 227616;800 1 16 32 2 231712;
"""
FROZEN_F32 = """
16 1 16 1 4 66816;16 2 16 2 4 69888;16 3 16 3 4 72960;16 4 16 4 4 76032;
16 5 16 5 4 79104;16 6 16 6 4 82176;16 7 16 7 4 85248;16 8 16 8 4 88320;
16 9 16 9 4 91392;16 10 16 10 4 84224;16 11 16 11 4 87296;
16 12 16 12 4 88320;16 13 16 13 4 91392;16 14 16 14 4 92416;
16 15 16 15 4 95488;16 16 16 16 4 96512;16 17 16 17 4 99584;
16 18 16 18 4 100608;16 19 16 19 4 97536;16 20 16 20 4 98560;
16 21 16 21 4 99584;16 22 16 22 4 102656;16 23 16 23 4 103680;
16 24 16 24 4 104704;16 25 16 25 4 107776;16 26 16 26 4 108800;
16 27 16 27 4 109824;16 28 16 28 4 106752;16 29 16 29 4 109824;
16 30 16 30 4 110848;16 31 16 31 4 111872;16 32 16 32 4 112896;
16 33 16 33 4 115968;16 34 16 34 4 116992;16 35 16 35 4 118016;
16 36 16 36 4 119040;16 37 16 37 4 118016;16 38 16 38 4 119040;
16 39 16 39 4 120064;16 40 16 40 4 121088;16 41 16 41 4 124160;
16 42 16 42 4 125184;16 43 16 43 4 126208;16 44 16 44 4 127232;
16 45 16 45 4 128256;16 46 16 46 4 127232;16 47 16 47 4 128256;
16 48 16 48 4 129280;16 49 16 49 4 132352;16 50 16 50 4 133376;
16 51 16 51 4 134400;16 52 16 52 4 135424;16 53 16 53 4 136448;
16 54 16 54 4 137472;16 55 16 55 4 136448;16 56 16 56 4 137472;
16 57 16 57 4 140544;16 58 16 58 4 141568;16 59 16 59 4 142592;
16 60 16 60 4 143616;16 61 16 61 4 144640;16 62 16 62 4 145664;
16 63 16 63 4 146688;16 64 16 64 4 145664;16 65 16 65 4 148736;
16 66 16 66 4 149760;16 67 16 67 4 150784;16 68 16 68 4 151808;
16 69 16 69 4 152832;16 70 16 70 4 153856;16 71 16 71 4 154880;
16 72 16 72 4 155904;16 73 16 73 4 156928;16 74 16 74 4 157952;
16 75 16 75 4 158976;16 76 16 76 4 160000;16 77 16 77 4 161024;
16 78 16 78 4 162048;16 79 16 79 4 163072;16 80 16 80 4 164096;
16 81 16 81 4 165120;16 82 16 82 4 166144;16 83 16 83 4 167168;
16 84 16 84 4 168192;16 85 16 85 4 169216;16 86 16 86 4 170240;
16 87 16 87 4 171264;16 88 16 88 4 172288;16 89 16 89 4 173312;
16 90 16 90 4 174336;16 91 16 91 4 175360;16 92 16 92 4 176384;
16 93 16 93 4 177408;16 94 16 94 4 178432;16 95 16 95 4 179456;
16 96 16 96 4 180480;16 97 16 97 4 181504;16 98 16 98 4 182528;
16 99 16 99 4 183552;16 100 16 100 4 184576;16 101 16 101 4 185600;
16 102 16 102 4 186624;16 103 16 103 4 187648;16 104 16 104 4 188672;
16 105 16 105 4 189696;16 106 16 106 4 190720;16 107 16 107 4 191744;
16 108 16 108 4 192768;16 109 16 109 4 193792;16 110 16 110 4 194816;
16 111 16 111 4 195840;16 112 16 112 4 196864;16 113 16 113 4 197888;
16 114 16 114 4 198912;16 115 16 115 4 199936;16 116 16 116 4 200960;
16 117 16 117 4 201984;16 118 16 118 4 203008;16 119 16 119 4 204032;
16 120 16 120 4 205056;16 121 16 121 4 206080;16 122 16 122 4 207104;
16 123 16 123 4 208128;16 124 16 124 4 209152;16 125 16 125 4 210176;
16 126 16 126 4 211200;16 127 16 127 4 212224;16 128 16 128 4 213248;
16 129 16 129 4 214272;32 1 32 1 4 70144;32 2 32 2 4 76288;
32 3 32 3 4 82432;32 5 32 5 4 94720;32 7 32 7 4 107008;32 9 32 9 4 119296;
32 10 32 10 4 115200;32 11 32 11 4 121344;32 31 32 31 4 207360;
32 56 32 8 2 105984;32 57 32 9 2 115200;32 64 32 8 2 105984;
32 129 32 9 2 115200;48 1 16 1 4 68864;48 2 16 2 4 73984;
48 3 16 3 4 79104;48 5 16 5 4 89344;48 7 16 7 4 99584;48 9 16 9 4 109824;
48 10 16 10 4 104704;48 11 16 11 4 109824;48 31 16 31 4 175360;
48 56 16 56 3 232192;48 57 16 57 2 216320;48 64 16 8 2 89344;
48 129 16 9 2 96512;64 1 64 1 4 82944;64 2 64 2 4 101376;
64 3 64 3 4 119808;64 5 64 5 4 156672;64 7 64 7 4 193536;
64 9 64 9 4 230400;64 10 64 10 3 220160;64 11 64 11 2 219136;
64 31 64 5 2 201728;64 56 64 5 2 201728;64 57 64 5 2 201728;
64 64 64 5 2 201728;64 129 64 5 2 201728;80 1 16 1 4 70912;
80 2 16 2 4 78080;80 3 16 3 4 85248;80 5 16 5 4 99584;80 7 16 7 4 113920;
80 9 16 9 4 128256;80 10 16 10 4 125184;80 11 16 11 4 132352;
80 31 16 31 3 218880;80 56 16 8 2 122112;80 57 16 9 2 133376;
80 64 16 8 2 122112;80 129 16 9 2 133376;96 1 32 1 4 78336;
96 2 32 2 4 92672;96 3 32 3 4 107008;96 5 32 5 4 135680;
96 7 32 7 4 164352;96 9 32 9 4 193024;96 10 32 10 4 197120;
96 11 32 11 4 211456;96 31 32 7 2 211456;96 56 32 7 2 211456;
96 57 32 7 2 211456;96 64 32 7 2 211456;96 129 32 7 2 211456;
112 1 16 1 4 72960;112 2 16 2 4 82176;112 3 16 3 4 91392;
112 5 16 5 4 109824;112 7 16 7 4 128256;112 9 16 9 4 146688;
112 10 16 10 4 145664;112 11 16 11 4 154880;112 31 16 8 2 154880;
112 56 16 8 2 154880;112 57 16 9 2 170240;112 64 16 8 2 154880;
112 129 16 9 2 170240;128 1 64 1 4 99328;128 2 64 2 4 134144;
128 3 64 3 4 168960;128 4 64 4 4 203776;128 5 64 5 3 220160;
128 6 32 6 4 174592;128 7 32 7 4 193024;128 8 32 8 4 211456;
128 9 32 9 4 229888;128 10 32 10 3 219648;128 11 32 11 2 218624;
128 12 64 3 2 232448;128 13 64 3 2 232448;128 14 64 3 2 232448;
128 15 64 3 2 232448;128 16 64 3 2 232448;128 17 64 3 2 232448;
128 18 64 3 2 232448;128 19 64 3 2 232448;128 20 64 3 2 232448;
128 21 64 3 2 232448;128 22 64 3 2 232448;128 23 64 3 2 232448;
128 24 64 3 2 232448;128 25 64 3 2 232448;128 26 64 3 2 232448;
128 27 64 3 2 232448;128 28 64 3 2 232448;128 29 64 3 2 232448;
128 30 64 3 2 232448;128 31 64 3 2 232448;128 32 64 3 2 232448;
128 33 64 3 2 232448;128 34 64 3 2 232448;128 35 64 3 2 232448;
128 36 64 3 2 232448;128 37 64 3 2 232448;128 38 64 3 2 232448;
128 39 64 3 2 232448;128 40 64 3 2 232448;128 41 64 3 2 232448;
128 42 64 3 2 232448;128 43 64 3 2 232448;128 44 64 3 2 232448;
128 45 64 3 2 232448;128 46 64 3 2 232448;128 47 64 3 2 232448;
128 48 64 3 2 232448;128 49 64 3 2 232448;128 50 64 3 2 232448;
128 51 64 3 2 232448;128 52 64 3 2 232448;128 53 64 3 2 232448;
128 54 64 3 2 232448;128 55 64 3 2 232448;128 56 64 3 2 232448;
128 57 64 3 2 232448;128 58 64 3 2 232448;128 59 64 3 2 232448;
128 60 64 3 2 232448;128 61 64 3 2 232448;128 62 64 3 2 232448;
128 63 64 3 2 232448;128 64 64 3 2 232448;128 65 64 3 2 232448;
128 66 64 3 2 232448;128 67 64 3 2 232448;128 68 64 3 2 232448;
128 69 64 3 2 232448;128 70 64 3 2 232448;128 71 64 3 2 232448;
128 72 64 3 2 232448;128 73 64 3 2 232448;128 74 64 3 2 232448;
128 75 64 3 2 232448;128 76 64 3 2 232448;128 77 64 3 2 232448;
128 78 64 3 2 232448;128 79 64 3 2 232448;128 80 64 3 2 232448;
128 81 64 3 2 232448;128 82 64 3 2 232448;128 83 64 3 2 232448;
128 84 64 3 2 232448;128 85 64 3 2 232448;128 86 64 3 2 232448;
128 87 64 3 2 232448;128 88 64 3 2 232448;128 89 64 3 2 232448;
128 90 64 3 2 232448;128 91 64 3 2 232448;128 92 64 3 2 232448;
128 93 64 3 2 232448;128 94 64 3 2 232448;128 95 64 3 2 232448;
128 96 64 3 2 232448;128 97 64 3 2 232448;128 98 64 3 2 232448;
128 99 64 3 2 232448;128 100 64 3 2 232448;128 101 64 3 2 232448;
128 102 64 3 2 232448;128 103 64 3 2 232448;128 104 64 3 2 232448;
128 105 64 3 2 232448;128 106 64 3 2 232448;128 107 64 3 2 232448;
128 108 64 3 2 232448;128 109 64 3 2 232448;128 110 64 3 2 232448;
128 111 64 3 2 232448;128 112 64 3 2 232448;128 113 64 3 2 232448;
128 114 64 3 2 232448;128 115 64 3 2 232448;128 116 64 3 2 232448;
128 117 64 3 2 232448;128 118 64 3 2 232448;128 119 64 3 2 232448;
128 120 64 3 2 232448;128 121 64 3 2 232448;128 122 64 3 2 232448;
128 123 64 3 2 232448;128 124 64 3 2 232448;128 125 64 3 2 232448;
128 126 64 3 2 232448;128 127 64 3 2 232448;128 128 64 3 2 232448;
128 129 64 3 2 232448;256 1 64 1 4 132096;256 2 64 2 4 199680;
256 3 64 3 2 232448;256 5 32 5 3 219648;256 7 32 3 2 231936;
256 9 32 3 2 231936;256 10 32 3 2 231936;256 11 32 3 2 231936;
256 31 32 3 2 231936;
"""


def _frozen(table: str) -> list[list[int]]:
    return [list(map(int, e.split())) for e in table.replace("\n", "")
            .split(";") if e.strip()]


@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
def test_plans_taken_before_are_unchanged(dtype):
    if dtype == BF16:
        rows = _frozen(FROZEN_BF16)
        want = {(c, k): dict(cb=cb, kw=kw, stages=st, smem=sm)
                for c, k, cb, kw, st, sm in rows}
    else:
        rows = _frozen(FROZEN_F32)
        want = {(c, k): dict(route="f32_ring", cb=cb, kw=0, tile=32,
                             taps=taps, stages=st, smem=sm)
                for c, k, cb, taps, st, sm in rows}
    assert len(want) == (332 if dtype == BF16 else 345)
    for (c, k), plan in want.items():
        assert fused_conv.conv_plan(c, k, dtype) == plan, (c, k)


def _flagship(filters: int) -> dict:
    """The flagship config with ``filters`` channels in place of 128."""
    cfg = flagship_config()
    for layer in cfg["model"]["representation_learner"]["hidden_layers"]:
        if layer.get("config", {}).get("filters") == 128:
            layer["config"]["filters"] = filters
    return cfg


def test_flagship_c200_forward_matches_jax():
    """k 7 entry conv, DYT + NMD, three k 5 DYT residual blocks of 200
    channels (route ``wgmma_stream`` in bf16 on the card; the plain
    version here), the masked program at f32."""
    cfg = _flagship(200)
    tm = build_model(copy.deepcopy(cfg))
    convs = [m.conv1 for m in tm.modules() if isinstance(m, TL.ResidualBlock)]
    assert len(convs) == 3
    assert all(c.filters == 200 and c.fused(BF16, False) for c in convs)
    assert fused_conv.conv_plan(200, 5, BF16)["route"] == "wgmma_stream"
    _forward_matches_jax(cfg, 61, n=4)


def _dyt_config(filters: int, kernel_size: int) -> dict:
    """``_residual_config`` with the flagship's DYT norms in place of the
    batch norms: the step's gradients then depend on no batch statistics,
    which at C 192 move JAX's own classifier gradient by 4e-5 of its scale
    under a one-ulp change of the weights (about the tolerance)."""
    cfg = _residual_config(filters, kernel_size)
    layers = cfg["model"]["representation_learner"]["hidden_layers"]
    for layer in layers:
        if layer["name"] == "masked_batchnorm":
            layer["name"] = "masked_dyt"
        if layer["name"] == "residual_block":
            layer["config"]["norm_type"] = "masked_dyt"
    return cfg


@pytest.mark.parametrize("program", ["dense", "masked"])
def test_c192_f32_train_step_matches_jax(program):
    """One f32 step of a C 192, k 3 residual block with DYT norms:
    ``conv_plan`` and ``check_wgrad_shape`` take it, so it trains on the
    fused path (the forward, the flipped-weight data gradient and
    ``conv_wgrad``)."""
    cfg = _dyt_config(192, 3)
    tm = build_model(copy.deepcopy(cfg))
    block = [m for m in tm.modules() if isinstance(m, TL.ResidualBlock)][0]
    assert block.conv1.fused(F32, True) and block.conv2.fused(F32, True)
    variables = _variables(cfg, 62)
    rng = np.random.default_rng(63)
    bases, lengths = _bases(rng, tm.crop_nt, program)
    labels = np.eye(3, dtype=np.float32)[rng.integers(0, 3, size=6)]
    common = dict(loss_name="categorical_crossentropy",
                  loss_params={"from_logits": True}, heads=("prediction",))
    if program == "dense":
        common["assume_dense"] = True
    _check_step(cfg, ModelBuilder(copy.deepcopy(cfg)).build(), variables,
                {"bases": bases, "lengths": lengths, "labels": labels},
                common, 0.003)


def test_c40_run_core_tsv_byte_identical_to_jax(tmp_path):
    """``run_core`` at f32 with a seeded C 40 bundle, whose residual convs
    now take the fused route: the TSV equals JAX's byte for byte."""
    from jaeger_tpu.commands.predict import run_core as jax_run_core
    from jaeger_tpu_torch.commands.predict import run_core

    cfg = _residual_config(40, 3)
    tm = build_model(copy.deepcopy(cfg))
    assert all(m.conv1.fused(F32, False) for m in tm.modules()
               if isinstance(m, TL.ResidualBlock))
    bundle = save_model(params_from_jax(_variables(cfg, 64)), cfg,
                        tmp_path / "c40")
    common = dict(input_path=FASTA, model_path=str(bundle),
                  fsize=tm.crop_nt, stride=tm.crop_nt, batch=512,
                  precision="float32")
    want = jax_run_core(output_dir=str(tmp_path / "jax"), **common)
    got = run_core(output_dir=str(tmp_path / "torch"), device="cpu",
                   workers=1, **common)
    assert want.read_bytes().count(b"\n") == 10          # header + 9
    assert got.read_bytes() == want.read_bytes()


def test_stream_kernel_source_declares_its_instances():
    """The C entry launches ``conv_bf16_stream`` at every column width of
    the plans; x and the weights come by TMA where C % 8 == 0 (two tensor
    maps; the weights multicast across a cluster), else by 2-byte loads,
    in_mask's bytes beside each x stage; the weights are an MN-major
    wgmma operand; one wgmma group stays in flight across the steps
    (``wgmma_wait<0>`` only once a tile, before its epilogue); no pad or
    copy sits around the launch."""
    import inspect
    import re
    from pathlib import Path

    src = (Path(fused_conv.__file__).resolve().parent.parent / "csrc"
           / "fused_conv_block.cu").read_text()
    assert ("conv_bf16_stream(Params p, StreamLayout lay, int n_rows,"
            in src)
    for cb in fused_conv.STREAM_WIDTHS:
        assert f"case {cb}: return (int)launch_stream<{cb}>(" in src
    kernel = src[src.index("conv_bf16_stream(Params p"):
                 src.index("// f32: conv_f32_ring, the persistent FMA")]
    for call in ("tma_load_3d(xs, &xmap", "tma_load_3d_multicast(",
                 "xd[lay.xrows + r]", "copy8_bf16(",
                 "wgmma_bf16_rs_mn_n<CB>(acc", "mbar_arrive_cluster(",
                 "cluster_sync()"):
        assert call in kernel, call
    # the steps drain nothing: wait_group 1 once a step has issued its
    # group, 0 once a tile, before its epilogue
    assert kernel.count("wgmma_wait<1>()") == 1
    assert kernel.count("wgmma_wait<0>()") == 1
    step = kernel[kernel.index("auto step = [&]"):
                  kernel.index("uint32_t aA[4][4], aB[4][4];")]
    assert "wgmma_wait<0>" not in step and "wgmma_wait<1>" in step
    launch = src[src.index("cudaError_t launch_stream("):]
    assert "cudaLaunchAttributeClusterDimension" in launch
    assert len(re.findall(r"encode_bf16_3d\(&[xw]map", launch)) == 2
    assert ("make_stream_layout(n_rows, L, C, K, cb, kw, taps, stages, "
            "wstages,") in src
    launch_py = inspect.getsource(fused_conv._launch)
    assert "F.pad" not in launch_py and ".contiguous()" not in launch_py


def _padded_share(c: int, k: int) -> float:
    """The share of the streamed plan's products that fall on padding:
    each column block's cb columns times the k16 steps its chunks issue
    (C rounded up to 16), against C x C a tap."""
    plan = fused_conv.conv_plan(c, k)
    blocks = -(-c // plan["cb"])
    done = blocks * plan["cb"] * (-(-c // 16) * 16) * k
    return 1 - c * c * k / done


def test_c200_takes_one_column_block():
    """C 200 k 5 (the C 200 flagship's residual convs): one column block of
    208 (no second pass over x), at most 10 % of the products padded (the
    old plan's two blocks of 128 over four chunks of 64: 39 %), weights
    streamed by TMA and multicast to a cluster of 2."""
    plan = fused_conv.conv_plan(200, 5)
    assert plan == dict(route="wgmma_stream", cb=208, kw=64, taps=5,
                        stages=3, wstages=5, cluster=2, smem=220544)
    assert _padded_share(200, 5) <= 0.10


@pytest.mark.parametrize("c,k,want", [
    # C 1024: four column blocks of 256, weights streamed, no multicast
    (1024, 5, dict(cb=256, taps=5, stages=3, wstages=5, cluster=1,
                   smem=221312)),
    # k 61: one block of 128, all 61 taps in one x stage (188 rows)
    (128, 61, dict(cb=128, taps=61, stages=3, wstages=8, cluster=1,
                   smem=208048)),
    # C 40 k 3: the tile's 3 weight steps resident, 4 x stages
    (40, 3, dict(cb=48, taps=3, stages=4, wstages=3, cluster=1,
                 smem=96112)),
    # k 200 past a TMA box's 256 rows: two blocks of 100 taps
    (200, 200, dict(cb=208, taps=100, stages=2, wstages=5, cluster=2,
                    smem=227696)),
])
def test_stream_layouts(c, k, want):
    plan = fused_conv.conv_plan(c, k)
    assert plan == dict(route="wgmma_stream", kw=64, **want)
    assert plan["smem"] <= fused_conv.SMEM_LIMIT


@pytest.mark.parametrize("c,k", [(37, 3), (5, 2), (1, 1), (300, 5),
                                 (1100, 129), (37, 129)])
def test_rows_off_16_bytes_keep_the_copying_producer(c, k):
    """C % 8 != 0: no tensor map describes the rows, so the producer copies
    by 2-byte loads (no multicast: cluster 1); the plan is the same
    layout."""
    plan = fused_conv.conv_plan(c, k)
    assert c % 8 and plan["route"] == "wgmma_stream"
    assert plan["cluster"] == 1
    assert plan["smem"] == _layout_bytes(c, k, plan)


def test_no_stream_plan_exceeds_shared_memory():
    for c in list(range(1, 300)) + [511, 512, 777, 1000, 1024, 1100, 2048]:
        for k in (1, 3, 5, 57, 128, 129, 130, 300):
            plan = fused_conv.stream_plan(c, k)
            assert plan["smem"] <= fused_conv.SMEM_LIMIT, (c, k, plan)
            assert plan["smem"] == _layout_bytes(c, k, plan), (c, k, plan)
