"""K1–K3 over bfloat16 and mixed-dtype state: the plain versions the CUDA
kernels are held to (``kernels/ref.py``, what ``kernels.ops`` runs on the
CPU) against the JAX package's jnp oracles and Pallas kernels (interpret
mode), bit for bit, and the host half of the bfloat16 launches.

K2 rounds op by op as jnp does: alpha to the state's dtype (a weakly typed
scalar), alpha·U to it, the sums to the promotion of the state's and the
gradient's dtypes; the jnp oracle keeps that promotion, the Pallas kernel
stores the state's dtype. K3 writes the promotion of the state's and the
mask's dtypes (jnp) or the state's (Pallas). K1 forms z and the norms in
float32 from the bfloat16 inputs and writes the mask in v's dtype. All of
it is held bitwise against eager jnp. Jitted, XLA on the CPU still rounds
bfloat16 ``alpha*u + g`` once per op, as torch does (bitwise too); where
the arithmetic is float32 it contracts ``alpha*u + g`` into one fused
multiply-add (ROADMAP R3), and with a bfloat16 state and a float32
gradient it skips the bfloat16 rounding of ``alpha*u``: those are held
within 1e-5 relative (float32; the Pallas kernel runs jitted in interpret
mode, so its float32 instance too) and 2**-8 (one bfloat16 rounding).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread: its docstring)
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.kernels import gmf_compress as jgk
from repro.kernels import ref as jref
from repro_torch.kernels import gmf_compress as gk
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.utils.convert import from_jax_params, to_jax_params

DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _pair(rng, shape, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    a = jnp.asarray(rng.normal(size=shape).astype(np.float32)).astype(DT[dtype][0])
    return a, from_jax_params(np.asarray(a), layout="transformer")


def _same(got, want):
    assert str(got.dtype).replace("torch.", "") == str(want.dtype), (got.dtype, want.dtype)
    np.testing.assert_array_equal(to_jax_params(got, layout="transformer"), np.asarray(want))


def _close(got, want, rel=1e-5):
    assert str(got.dtype).replace("torch.", "") == str(want.dtype), (got.dtype, want.dtype)
    g = np.asarray(to_jax_params(got, layout="transformer"), np.float64)
    w = np.asarray(want, np.float64)
    assert np.abs(g - w).max() <= rel * np.abs(w).max()


@pytest.mark.parametrize("jit", [False, True])
@pytest.mark.parametrize("s, g", [("bf16", "bf16"), ("f32", "bf16"), ("bf16", "f32"),
                                  ("f32", "f32")])
def test_k2_plain_version_is_jnp(s, g, jit):
    rng = np.random.default_rng(0)
    (ju, tu), (jv, tv), (jg, tg) = (_pair(rng, (3, 4099), d) for d in (s, s, g))
    fn = jax.jit(jref.momentum_correction_leaf, static_argnums=3) if jit else \
        jref.momentum_correction_leaf
    want_u, want_v = fn(ju, jv, jg, 0.9)
    got_u, got_v = tref.momentum_correction_leaf(tu, tv, tg, 0.9)
    if not jit or (s, g) == ("bf16", "bf16"):
        check = _same
    elif s == "bf16":  # jitted XLA keeps alpha*u unrounded: one bf16 rounding of it
        check = lambda a, b: _close(a, b, rel=2.0**-8)
    else:
        check = _close
    check(got_u, want_u)
    check(got_v, want_v)


@pytest.mark.parametrize("s", ["bf16", "f32"])
def test_k2_state_dtype_mode_is_the_pallas_kernel(s):
    rng = np.random.default_rng(1)
    (ju, tu), (jv, tv), (jg, tg) = (_pair(rng, (2, 3000), d) for d in (s, s, s))
    want_u, want_v = jgk.momentum_correction_flat(ju, jv, jg, 0.9, interpret=True)
    got_u, got_v = tops.momentum_correction(tu, tv, tg, 0.9, state_dtype=True)
    check = _same if s == "bf16" else _close
    check(got_u, want_u)
    check(got_v, want_v)


@pytest.mark.parametrize("s, m", [("bf16", "f32"), ("bf16", "bf16"), ("f32", "f32")])
def test_k3_both_semantics(s, m):
    rng = np.random.default_rng(2)
    (ju, tu), (jv, tv) = (_pair(rng, (2, 2048), s) for _ in range(2))
    mask = (rng.random((2, 2048)) < 0.1).astype(np.float32)
    jm = jnp.asarray(mask).astype(DT[m][0])
    tm = torch.from_numpy(mask).to(DT[m][1])
    for got, want in zip(tops.apply_mask_update(tu, tv, tm),
                         jref.apply_mask_update_leaf(ju, jv, jm), strict=True):
        _same(got, want)  # jnp: the promotion
    for got, want in zip(tops.apply_mask_update(tu, tv, tm, state_dtype=True),
                         jgk.apply_mask_flat(ju, jv, jm, interpret=True), strict=True):
        _same(got, want)  # Pallas: the state's dtype


@pytest.mark.parametrize("s, m", [("bf16", "bf16"), ("f32", "bf16")])
def test_k1_mask_pass_matches_pallas_on_bf16(s, m):
    rng = np.random.default_rng(3)
    (ju, tu), (jv, tv) = (_pair(rng, (1, 5000), s) for _ in range(2))
    jmm, tmm = _pair(rng, (1, 5000), m)
    inv_nv, inv_nm, tau = 0.013, 0.021, 0.3
    z = np.abs((1 - tau) * np.asarray(jv, np.float32) * inv_nv
               + tau * np.asarray(jmm, np.float32) * inv_nm)
    top = np.sort(z.reshape(-1))
    thr = float((top[-500] + top[-501]) / 2)  # no score ties the threshold
    want = jgk.gmf_compress_flat(ju[0], jv[0], jmm[0], inv_norm_v=inv_nv, inv_norm_m=inv_nm,
                                 tau=tau, threshold=thr, interpret=True)
    got = tref.gmf_compress_leaf(tu, tv, tmm, inv_norm_v=torch.tensor([inv_nv]),
                                 inv_norm_m=torch.tensor([inv_nm]), tau=torch.tensor([tau]),
                                 threshold=torch.tensor([thr]))
    for a, b in zip(got, want, strict=True):
        _same(a[0], b)
    assert int(got[3].float().sum()) == 500


def test_k2_table_takes_bf16_and_mixed_dtypes():
    """The host half of a bfloat16 launch: outputs of the promotion (or the
    state's dtype when asked), laid out at 2-byte offsets, quad alignment
    per operand type (8 bytes for bfloat16), and the instance's dtypes."""
    bf, f32 = torch.bfloat16, torch.float32
    us = [torch.zeros(2, 3, dtype=bf), torch.zeros(2, 5, dtype=bf)]
    gs = [torch.zeros(2, 3, dtype=bf), torch.zeros(2, 5, dtype=bf)]
    table = gk.momentum_table(us, us, gs, 8, 4)
    assert table.dtypes == (bf, bf, bf)
    assert [o.dtype for o in table.uo] == [bf, bf]
    (rows, count, _), = table.launches
    assert rows[1, 3] - rows[0, 3] == 6 * 2  # the second leaf 6 bf16 after the first
    mixed = gk.momentum_table(us, us, [g.float() for g in gs], 8, 4)
    assert mixed.dtypes == (bf, f32, f32) and mixed.uo[0].dtype == f32
    kept = gk.momentum_table(us, us, [g.float() for g in gs], 8, 4, out_dtype=bf)
    assert kept.dtypes == (bf, f32, bf)
    with pytest.raises(TypeError):
        gk.momentum_table(us, us, gs, 8, 4, out_dtype=torch.float16)
    with pytest.raises(ValueError):
        gk.momentum_table(us, [u.float() for u in us], gs, 8, 4)
    assert gk.instance(bf, f32, out=f32) == "bf16,f32->f32"
