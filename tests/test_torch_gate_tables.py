"""The activation tables of the all-bf16 gate kernels, on the CPU.

``lstm_gates_{fwd,bwd}_bf16s`` (``ivf_tpu_torch/csrc/fused_gates.cu``)
read bf16(s(z)) and bf16(tanh(z)) from tables of the exact device
functions over all 65,536 bf16 inputs, packed as a range of magnitudes
between two constants of the sign per family, and compute the backward's
factor bf16(s * bf16(1 - s)) from the tabled s.
``fused_gates.gate_table_twin`` / ``gate_table_lookup`` are their plain
twin (the same derivation and the same clamped index); here, on every
bf16 input, "tabled value, else constant, else exact" must give the plain
block's activations bit for bit, and the block computed from the tables
in the kernels' order must give the plain block's outputs bit for bit with
every bf16 pattern in every operand slot. The card builds its own tables
from CUDA's ``expf`` / ``tanhf`` and is held to the same bits by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ivf_tpu_torch.ops.kernels import fused_gates as gates

ALL = torch.arange(65536, dtype=torch.int32)
FAMILIES = ("sigmoid", "sigmoid_factor", "tanh")


def _bits(t):
    """The bit patterns of a bf16 tensor, int32 (NaN payloads kept)."""
    return t.contiguous().view(torch.int16).to(torch.int32) & 0xFFFF


def _sig_factor(s):
    """bf16(s * bf16(1 - s)) of sigmoid bits ``s``, as bits: the kernels'
    ``sig_factor``, rounded float32 operations on the tabled s."""
    v = gates._bf16_of_bits(s).float()
    return gates._bits_of(v * gates._bf16(1 - v))


def _lookup(twin, u):
    """The bits of (s, its factor, tanh) as the kernels get them: s and
    tanh through ``gate_table_lookup``, the factor from the looked-up s."""
    s, t = gates.gate_table_lookup(twin, u)
    return s, _sig_factor(s), t


def _exact(u):
    """The bits of (s, its factor, tanh) as the plain block computes them
    (``_gate_math_bwd_bf16``'s ``b(i * b(1 - i))`` for the factor)."""
    s, t = gates._exact_activations(u)
    return s, _sig_factor(s), t


@pytest.fixture(scope="module")
def twin():
    return gates.gate_table_twin()


@pytest.mark.parametrize("family", FAMILIES)
def test_lookup_equals_exact_on_every_bf16(twin, family):
    """Table, else the sign's constant (or tanh's pass-through), else the
    exact function for NaN: equal bits to the plain block's activation on
    all 65,536 inputs, NaNs, infinities, zeros and subnormals included."""
    k = FAMILIES.index(family)
    got = _lookup(twin, ALL)[k]
    want = _exact(ALL)[k]
    bad = (got != want).nonzero().flatten()
    assert len(bad) == 0, f"{family}: {len(bad)} inputs differ, first 0x{int(bad[0]):04x}"


def test_saturation_constants_and_pass_through(twin):
    """What the clamped index reads outside the ranges: s(+-0) = 0.5 (its
    factor 0.25) below the sigmoid's range; s = 1 (+) and 0 (-), factor 0,
    from its end on; tanh = +-1 from its end on and tanh(z) = z below its
    start. The ranges are whole bf16 binades or parts of them inside
    [2^-9, 2^7) for the sigmoid and [2^-5, 4) for tanh."""
    bits = {v: int(gates._bits_of(torch.tensor(v))) for v in (0.5, 0.25, 1.0, 0.0, -1.0)}
    for sign in (0, 1):
        base = sign * (twin["sspan"] + 2)
        small, large = twin["s"][base], twin["s"][base + twin["sspan"] + 1]
        assert int(small) == bits[0.5] and int(_sig_factor(small)) == bits[0.25]
        assert int(large) == (bits[0.0] if sign else bits[1.0]) and int(_sig_factor(large)) == bits[0.0]
        assert int(twin["t"][sign * (twin["tspan"] + 2) + twin["tspan"] + 1]) == (bits[-1.0] if sign else bits[1.0])
    below = ALL[(ALL & 0x7FFF) < twin["tlo"]]
    assert torch.equal(gates._exact_activations(below)[1], below)
    lo_s, hi_s = twin["slo"], twin["slo"] + twin["sspan"]
    lo_t, hi_t = twin["tlo"], twin["tlo"] + twin["tspan"]
    assert (118 << 7) <= lo_s < hi_s <= (134 << 7) and (122 << 7) <= lo_t < hi_t <= (129 << 7)


def test_tables_fit_the_kernels_budget(twin):
    """The packed S and T regions (16-byte aligned each), which every block
    of the kernels copies into shared memory, fit their budget without
    opting in to more shared memory."""
    assert twin["bytes"] <= gates.GATE_TABLE_BYTES_MAX and twin["bytes"] % 16 == 0
    assert len(twin["s"]) == 2 * (twin["sspan"] + 2)
    assert len(twin["t"]) == 2 * (twin["tspan"] + 2)


def test_tables_against_jax(twin):
    """The tables against the JAX package's bf16 activations (``jax.jit``
    of ``jax.nn.sigmoid``, of ``s * (1 - s)`` and of ``jnp.tanh`` on bf16,
    as its bf16 train step computes them): equal bits on every finite
    input, except where XLA's CPU flushes a subnormal result to zero (the
    sigmoid of z in [-88.5, -87.5], 3 inputs), where the port keeps the
    subnormal, as PyTorch does on the CPU and the card."""
    x = jnp.asarray(np.arange(65536, dtype=np.uint16).view(np.int16)).view(jnp.bfloat16)

    def sig_factor(v):
        s = jax.nn.sigmoid(v)
        return s * (1 - s)

    finite = (ALL & 0x7FFF) < 0x7F80
    got = _lookup(twin, ALL)
    for k, fn in enumerate((jax.nn.sigmoid, sig_factor, jnp.tanh)):
        want = torch.from_numpy(np.asarray(jax.jit(fn)(x)).view(np.uint16).astype(np.int32))
        differ = finite & (got[k] != want)
        subnormal = ((got[k] & 0x7F80) == 0) & ((got[k] & 0x7F) != 0)
        assert bool((want[differ] == 0).all() and subnormal[differ].all()), [hex(int(u)) for u in ALL[differ][:5]]
        assert int(differ.sum()) == (3 if k < 2 else 0)


def _tabled_block(twin, gx, gh, c, dh, dc_out):
    """The all-bf16 block as the kernels compute it: z = bf16(gx + gh)
    as bits, each activation read through ``gate_table_lookup``, the
    backward's factors computed from the looked-up sigmoids, the products
    and sums between them float32 operations rounded to bf16 in
    ``gate_bwd_bf16s``'s order; an element with an infinite or NaN gate or
    c takes the plain block. Returns bf16 (h', c', dz, dc)."""
    b = gates._bf16
    ch = c.shape[-1]
    zt = gx if gh is None else (gx.float() + gh.float()).bfloat16()
    zbits = _bits(zt).view(-1, 4, ch)
    z = [zbits[:, k, :].reshape(-1) for k in range(4)]
    cbits = _bits(c).view(-1)
    cf, dhf, dcof = c.float().view(-1), dh.float().view(-1), dc_out.float().view(-1)

    def f32(u):
        return gates._bf16_of_bits(u).float()

    (si, _), (sf, _), (_, gb), (so, _) = (gates.gate_table_lookup(twin, u) for u in z)
    i, f, g, o = f32(si), f32(sf), f32(gb), f32(so)
    cn = b(b(f * cf) + b(i * g))
    tc = f32(gates.gate_table_lookup(twin, gates._bits_of(cn))[1])
    h = b(o * tc)
    e = b(b(o * dhf) * b(1 - tc))
    dcn = b(b(dcof + e) + b(e * tc))
    dzc = b(b(i * dcn) * b(1 - g))
    dz = torch.stack([b(dcn * g) * f32(_sig_factor(si)), b(dcn * cf) * f32(_sig_factor(sf)), dzc + b(dzc * g),
                      b(dhf * tc) * f32(_sig_factor(so))], 1)
    dc = f * dcn
    exact = torch.stack([u & 0x7FFF for u in (*z, cbits)]).amax(0) >= 0x7F80
    h_p, c_p = gates.gate_math_plain(gx, gh, c)
    dz_p, dc_p = gates.gate_math_bwd_plain(gx, gh, c, dh, dc_out)
    rows = c.shape[0]
    dz = torch.where(exact[:, None], dz_p.float().view(-1, 4, ch).transpose(1, 2).reshape(-1, 4), dz)
    dz = dz.view(rows, ch, 4).transpose(1, 2).reshape(rows, 4 * ch)
    outs = [torch.where(exact, p.float().view(-1), v).view(rows, ch) for p, v in ((h_p, h), (c_p, cn), (dc_p, dc))]
    return outs[0].bfloat16(), outs[1].bfloat16(), dz.bfloat16(), outs[2].bfloat16()


@pytest.mark.parametrize("with_gh", [False, True], ids=["merged", "gates_h"])
def test_tabled_block_equals_plain_with_every_pattern(twin, with_gh):
    """Every one of the 65,536 bf16 patterns in each operand slot (the four
    gates, c, dh, dc'), the others seeded: the block computed from the
    tables in the kernels' order has the plain block's bits in h', c', dz
    and dc, NaNs included."""
    ops = gates.exhaustive_operands(with_gh, ch=4, seed=5)
    h, cn, dz, dc = _tabled_block(twin, *ops)
    h_p, c_p = gates.gate_math_plain(*ops[:3])
    dz_p, dc_p = gates.gate_math_bwd_plain(*ops)
    bad = gates.first_unequal({"h": h, "c": cn, "dz": dz, "dc": dc}, {"h": h_p, "c": c_p, "dz": dz_p, "dc": dc_p}, 4)
    assert bad is None, bad


def test_exhaustive_operands_cover_every_pattern():
    """``exhaustive_operands`` puts each bf16 pattern into each slot once:
    z = bf16(gx + gh) is the pattern itself in its gate's block (gh -0.0
    there), c, dh and dc' in theirs."""
    gx, gh, c, dh, dc_out = gates.exhaustive_operands(True, ch=4)
    z = _bits((gx.float() + gh.float()).bfloat16()).view(-1, 4, 4)
    for j, slot in enumerate(gates.EXHAUSTIVE_SLOTS):
        block = slice(j * 65536, (j + 1) * 65536)
        if j < 4:
            got = z[:, j, :].reshape(-1)[block]
            # -0.0 + -0.0 keeps -0; NaN + -0.0 is a NaN (payloads may differ)
            nan = ((ALL & 0x7FFF) > 0x7F80)
            assert torch.equal(got[~nan], ALL[~nan]) and bool((((got[nan] & 0x7FFF) > 0x7F80)).all())
        else:
            t = {"c": c, "dh": dh, "dc_out": dc_out}[slot]
            assert torch.equal(_bits(t).view(-1)[block], ALL)
