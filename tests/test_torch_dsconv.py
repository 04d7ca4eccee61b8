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
from deepdish_tpu_torch.models.ssd_mobilenet import _DepthwiseSeparable
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
