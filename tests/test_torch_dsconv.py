"""Port parity of the fused depthwise-separable block (ops/dsconv.py)
against the JAX package (deepdish_tpu/ops/dsconv_pallas.py), on the CPU.

The same numpy inputs go through both: the port's `dsconv_reference` against
JAX's `dsconv_reference`, and the port's `fused_dsconv` on CPU tensors (its
plain version, which repeats the Pallas kernel's arithmetic) against the
Pallas kernel in interpret mode. The CUDA kernel itself runs only on the
card (tests/test_torch_gpu.py, chip_smoke.py)."""
import pytest

jax = pytest.importorskip("jax")

import numpy as np
import jax.numpy as jnp
import torch

from deepdish_tpu.ops import dsconv_pallas as jds
from deepdish_tpu_torch.kernels import dsconv as kds
from deepdish_tpu_torch.models.ssd_mobilenet import (_BACKBONE, INPUT_SIZE,
                                                     _DepthwiseSeparable)
from deepdish_tpu_torch.ops import dsconv as pds
from deepdish_tpu_torch.tools import probe_dsconv

# f32: the JAX kernel test's tolerance (tests/test_dsconv_pallas.py); only
# the order of the f32 sums differs between the two frameworks
F32_TOL = dict(atol=2e-5, rtol=1e-5)

SMALL = [
    (10, 12, 8, 16, 1),     # even spatial, stride 1
    (11, 13, 8, 16, 2),     # odd spatial, asymmetric SAME pad
    (10, 12, 8, 16, 2),     # even spatial stride 2 (pad top=0 side)
    (9, 9, 16, 8, 1),       # Cout < Cin
]
LARGE = [(75, 75, 16, 32, 1), (75, 75, 16, 32, 2)]


def _block_args(rng, b, h, w, cin, cout):
    return (rng.standard_normal((b, h, w, cin)).astype(np.float32),
            (rng.standard_normal((3, 3, cin)) * 0.2).astype(np.float32),
            (rng.random(cin) + 0.5).astype(np.float32),
            (rng.standard_normal(cin) * 0.1).astype(np.float32),
            (rng.standard_normal((cin, cout)) * 0.2).astype(np.float32),
            (rng.random(cout) + 0.5).astype(np.float32),
            (rng.standard_normal(cout) * 0.1).astype(np.float32))


def _torch(a):
    return [torch.from_numpy(v.copy()) for v in a]


@pytest.mark.parametrize("h,w,cin,cout,stride", SMALL + LARGE)
def test_reference_matches_jax_reference(h, w, cin, cout, stride):
    b = 2 if (h, w, cin, cout, stride) in SMALL else 1
    a = _block_args(np.random.default_rng(h * 100 + w + stride), b, h, w,
                    cin, cout)
    want = np.asarray(jds.dsconv_reference(*a, stride=stride))
    got = pds.dsconv_reference(*_torch(a), stride=stride)
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,w,cin,cout,stride", SMALL)
def test_plain_matches_pallas_interpret(h, w, cin, cout, stride, dtype):
    """The port's CPU path against the Pallas kernel run by the interpreter.
    bf16: dtype preserved, and within reorder_tolerance (both round the
    intermediate at the same point; only the order of the f32 pointwise
    sum, XLA's dot against torch's matmul, may differ)."""
    a = _block_args(np.random.default_rng(h * 100 + w + stride), 2, h, w,
                    cin, cout)
    t = _torch(a)
    if dtype == "float32":
        want = np.asarray(jds.fused_dsconv(*a, stride=stride,
                                           interpret=True))
        got = pds.fused_dsconv(*t, stride=stride)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
        return
    want = jds.fused_dsconv(jnp.asarray(a[0], jnp.bfloat16), *a[1:],
                            stride=stride, interpret=True)
    assert want.dtype == jnp.bfloat16
    got = pds.fused_dsconv(t[0].bfloat16(), *t[1:], stride=stride)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    want = torch.from_numpy(np.array(want.astype(jnp.float32))).bfloat16()
    tol = pds.reorder_tolerance(got, want, t[0].bfloat16(), *t[1:],
                                stride=stride)
    assert bool(((got.float() - want.float()).abs() <= tol).all())


@pytest.mark.parametrize("cin,cout,stride", [(256, 48, 1), (1024, 16, 2)])
def test_reorder_tolerance_covers_the_kernels_sum_order(cin, cout, stride):
    """The CUDA kernel sums the pointwise product sequentially over Cin
    (exact bf16 products, f32 adds); modelled here with a cumulative sum,
    that order stays within reorder_tolerance of dsconv_plain's matmul."""
    a = _torch(_block_args(np.random.default_rng(cin + stride), 2, 7, 9,
                           cin, cout))
    x = a[0].bfloat16()
    want = pds.dsconv_plain(x, *a[1:], stride=stride)
    ones = torch.ones(cin)
    mid = pds.dsconv_plain(x, *a[1:4], torch.eye(cin), ones,
                           torch.zeros(cin), stride=stride).float()
    pw = a[4].bfloat16().float()
    y = (mid[..., :, None] * pw).cumsum(-2)[..., -1, :]
    seq = (y * a[5] + a[6]).clamp(0.0, 6.0).bfloat16()
    tol = pds.reorder_tolerance(seq, want, x, *a[1:], stride=stride)
    assert bool(((seq.float() - want.float()).abs() <= tol).all())


@pytest.mark.parametrize("cin,cout,stride,k_chunk", [
    (256, 48, 1, 96), (1024, 16, 2, 128), (40, 24, 1, 16), (512, 32, 2, 512)])
def test_reorder_tolerance_covers_the_wgmma_sum_order(cin, cout, stride,
                                                      k_chunk):
    """The bf16 kernel's order (csrc/dsconv.cu): exact bf16 products summed
    16 at a time per wgmma k16 step (modelled by a sum of 16 in f32), the
    steps added in turn into the f32 accumulator, then the K splits of
    k_chunk channels added in split order. That order too stays within
    reorder_tolerance of dsconv_plain's matmul."""
    a = _torch(_block_args(np.random.default_rng(cin + cout), 2, 7, 9, cin,
                           cout))
    x = a[0].bfloat16()
    want = pds.dsconv_plain(x, *a[1:], stride=stride)
    ones = torch.ones(cin)
    mid = pds.dsconv_plain(x, *a[1:4], torch.eye(cin), ones,
                           torch.zeros(cin), stride=stride).float()
    pw = a[4].bfloat16().float()
    prod = mid[..., :, None] * pw                        # exact in f32
    partials = []
    for k0 in range(0, cin, k_chunk):
        chunk = prod[..., k0:k0 + k_chunk, :]
        pad = -chunk.shape[-2] % 16                      # zero-padded K
        chunk = torch.nn.functional.pad(chunk, (0, 0, 0, pad))
        steps = chunk.unflatten(-2, (-1, 16)).sum(-2)    # one wgmma step
        partials.append(steps.cumsum(-2)[..., -1, :])
    y = torch.stack(partials).cumsum(0)[-1]
    got = (y * a[5] + a[6]).clamp(0.0, 6.0).bfloat16()
    tol = pds.reorder_tolerance(got, want, x, *a[1:], stride=stride)
    assert bool(((got.float() - want.float()).abs() <= tol).all())


def _ssd_blocks():
    """The port SSD's 13 ds blocks as (H, Cin, Cout, stride) at 300x300."""
    h, cin, out = -(-INPUT_SIZE // 2), 32, []
    for cout, stride in _BACKBONE:
        out.append((h, cin, cout, stride))
        h, cin = -(-h // stride), cout
    return out


@pytest.mark.parametrize(
    "b,h,cin,cout,stride",
    [(1,) + blk for blk in _ssd_blocks()] +
    [(32, h, cin, cout, s) for _, h, _, cin, cout, s in probe_dsconv.STAGES])
def test_launch_plan_covers_every_output_once(b, h, cin, cout, stride):
    """kernels.dsconv.plan at the SSD's 13 blocks at batch 1 and the probe's
    9 stages at batch 32 (no card, no nvcc): its blocks, mapped as the
    kernel maps blockIdx.x, cover every (pixel, output channel, input
    channel) once; K splits are whole wgmma steps (multiples of 16, the
    last one padded); the grid fills a wave of MIN_BLOCKS wherever the
    tiles and Cin / 16 allow it."""
    p = kds.plan(b, h, h, cin, cout, stride)
    ho = -(-h // stride)
    assert p.m == b * ho * ho and (p.cin, p.cout) == (cin, cout)
    assert p.block_n in (64, 128, 256) and p.k_chunk % 16 == 0
    blocks = [p.block(i) for i in range(p.grid)]
    assert len(set(blocks)) == p.grid
    m0s = sorted({m0 for m0, _, _, _ in blocks})
    n0s = sorted({n0 for _, n0, _, _ in blocks})
    ks = sorted({(k0, k1) for _, _, k0, k1 in blocks})
    assert m0s == list(range(0, p.m, kds.BLOCK_M))
    assert n0s == list(range(0, cout, p.block_n))
    assert ks[0][0] == 0 and ks[-1][1] == cin
    assert all(k1 == k0n for (_, k1), (k0n, _) in zip(ks, ks[1:]))
    assert all(k0 < k1 and k0 % 16 == 0 for k0, k1 in ks)
    assert len(blocks) == len(m0s) * len(n0s) * len(ks)
    tiles = len(m0s) * len(n0s)
    if tiles * -(-cin // 16) >= kds.MIN_BLOCKS:
        assert p.grid >= kds.MIN_BLOCKS
    if tiles >= kds.MIN_BLOCKS:
        assert p.k_splits == 1          # no split where the tiles fill a wave


def test_fold_bn_matches_batchnorm():
    """fold_bn reproduces inference BatchNorm: y = g*(x-m)/sqrt(v+eps)+b,
    as the JAX package's fold_bn does."""
    rng = np.random.default_rng(1)
    g, b = rng.random(8) + 0.5, rng.standard_normal(8)
    m, v = rng.standard_normal(8), rng.random(8) + 0.1
    x = rng.standard_normal((4, 8))
    scale, bias = pds.fold_bn(g, b, m, v, eps=1e-3)
    want = g * (x - m) / np.sqrt(v + 1e-3) + b
    np.testing.assert_allclose(x * scale + bias, want, rtol=1e-6)
    js, jb = jds.fold_bn(g, b, m, v, eps=1e-3)
    np.testing.assert_array_equal(scale, js)
    np.testing.assert_array_equal(bias, jb)


@pytest.mark.parametrize("h,w,cin,cout,stride", [
    (10, 12, 8, 16, 1), (11, 13, 16, 32, 2), (12, 12, 32, 16, 2)])
def test_plain_matches_port_module(h, w, cin, cout, stride):
    """Weights folded from a port `_DepthwiseSeparable` (`fused_args`; random
    convs and batch-norm statistics) give the module's own forward (NCHW)
    to 1e-5 of its output's range."""
    gen = torch.Generator().manual_seed(h + cin)
    mod = _DepthwiseSeparable(cin, cout, stride).eval()
    with torch.no_grad():
        for p in mod.parameters():
            p.normal_(0.0, 0.3, generator=gen)
        for bn in (mod.dw_bn, mod.pw_bn):
            bn.running_mean.normal_(0.0, 0.1, generator=gen)
            bn.running_var.uniform_(0.5, 1.5, generator=gen)
        x = torch.randn((2, cin, h, w), generator=gen)
        want = mod(x).permute(0, 2, 3, 1)
    got = pds.fused_dsconv(x.permute(0, 2, 3, 1).contiguous(),
                           *mod.fused_args(), stride=stride)
    assert got.shape == want.shape
    span = float(want.max() - want.min())
    assert span > 0
    assert float((got - want).abs().max()) <= 1e-5 * span


def test_fused_refuses_other_strides():
    a = _torch(_block_args(np.random.default_rng(0), 1, 6, 6, 4, 4))
    for fn in (pds.fused_dsconv, pds.dsconv_plain, pds.dsconv_reference):
        with pytest.raises(ValueError, match="stride"):
            fn(*a, stride=3)


@pytest.mark.parametrize("stage", ["ds13", "ds12"])
def test_probe_entry_point_on_cpu(stage, capsys):
    """The ported probe through its `main`, on the CPU (plain versions):
    one stage, chained (ds13) or summed (ds12), batch 1, one layer."""
    out = probe_dsconv.main(["--device", "cpu", "--batch", "1", "--layers",
                             "1", "--stages", stage, "--rounds", "1",
                             "--reps", "1"])
    assert len(out) == 1
    row = out[0]
    assert row["label"].startswith(stage) and row["batch"] == 1
    assert row["kind"] == ("chain" if stage == "ds13" else "sum")
    assert np.isfinite(row["maxdiff"]) and row["maxdiff"] < 0.5
    assert row["kernel_ms"] > 0 and row["library_ms"] > 0
    text = capsys.readouterr().out
    assert "cuda fused" in text and "sum over stages" in text
