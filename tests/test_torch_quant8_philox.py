"""quant8's Philox stream, on the CPU.

The CUDA kernel draws its stochastic-rounding uniforms from Philox4x32-10
in registers; ``quant8.philox_uniforms`` computes the same stream with
torch integer ops, and the card check holds the kernel to it bitwise.
Here that plain Philox is held to Random123's known answers, to exact
64-bit products, to the stream's layout, and to the statistics of a
uniform; and the plain version's generator route to its uniforms route.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np

from repro_torch.kernels import quant8 as q8

M32 = 0xFFFFFFFF

# Random123's known-answer vectors for philox4x32_10: counter, key, result
KNOWN_ANSWERS = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((M32, M32, M32, M32), (M32, M32),
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


def _words(counter, key):
    t = [torch.tensor(v, dtype=torch.int64) for v in (*counter, *key)]
    return tuple(int(w) for w in q8.philox4x32(*t))


@pytest.mark.parametrize("counter,key,want", KNOWN_ANSWERS)
def test_philox_known_answers(counter, key, want):
    assert _words(counter, key) == want


@pytest.mark.parametrize("b", [0xD2511F53, 0xCD9E8D57, M32, 0xFFFF0001])
def test_products_exact_near_the_top(b):
    """hi and lo of a * b equal Python's exact product, for operands at
    and near 2^32 - 1 (where an int64 product would overflow)."""
    a = [M32, M32 - 1, 0xFFFF0000, 0xFFFEFFFF, 0x80000000, 0x7FFFFFFF,
         0xFFFF, 0x10000, 1, 0]
    a += [int(v) for v in np.random.default_rng(0).integers(
        M32 - 2 ** 20, M32, 64, dtype=np.int64)]
    hi, lo = q8.mulhilo32(torch.tensor(a, dtype=torch.int64), b)
    for ai, h, l in zip(a, hi.tolist(), lo.tolist()):
        assert (h, l) == ((ai * b) >> 32, (ai * b) & M32)
    # both operands tensors
    hi, lo = q8.mulhilo32(torch.tensor(a, dtype=torch.int64),
                          torch.full((len(a),), b, dtype=torch.int64))
    assert hi.tolist() == [(ai * b) >> 32 for ai in a]
    assert lo.tolist() == [(ai * b) & M32 for ai in a]


@pytest.mark.parametrize("rows,d", [(3, 10), (2, 1), (2, 7), (4, 33)])
def test_stream_layout(rows, d):
    """Element (r, c) takes word c mod 4 of the draw at counter
    (g_lo, g_hi, 0, 0), g = r * ceil(d / 4) + c // 4, under the seed's two
    32-bit words; u = (word >> 8) * 2^-24."""
    seed = (0x1234567 << 32) | 0x89ABCDEF
    u = q8.philox_uniforms(torch.tensor([seed]), rows, d)
    assert u.shape == (rows, d) and u.dtype == torch.float32
    n4 = -(-d // 4)
    for r in range(rows):
        for c in range(d):
            g = r * n4 + c // 4
            word = _words((g & M32, g >> 32, 0, 0),
                          (seed & M32, seed >> 32))[c % 4]
            assert u[r, c].item() == (word >> 8) * 2.0 ** -24


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(16, 32), (2, 3, 5, 48), (7, 1001)])
def test_generator_route_is_the_philox_stream(dtype, shape):
    """quant_dequant_plain(x, gen) is quant_dequant_plain(x, u) with u the
    Philox stream of the seed a twin generator gives."""
    x = np.random.default_rng(1).standard_normal(shape, dtype=np.float32)
    x = torch.from_numpy(x * np.linspace(0.1, 3.0, shape[-1],
                                         dtype=np.float32)).to(dtype)
    gen = torch.Generator().manual_seed(9)
    twin = torch.Generator().manual_seed(9)
    seed = torch.randint(0, 2 ** 62, (1,), dtype=torch.int64, generator=twin)
    u = q8.philox_uniforms(seed, x.numel() // shape[-1], shape[-1])
    got = q8.quant_dequant_plain(x, gen)
    assert torch.equal(got, q8.quant_dequant_plain(x, u.reshape(shape)))
    # the generator moved on: the next call draws another seed
    assert not torch.equal(q8.quant_dequant_plain(x, gen), got)


def test_uniform_statistics():
    """2^18 draws: all in [0, 1), the mean within 4 sigma of 1/2, and the
    lag-1 (words of one draw) and lag-4 (one word of neighbouring draws)
    correlations within 4 sigma of 0."""
    u = q8.philox_uniforms(torch.tensor([12345]), 64, 4096).double()
    u = u.reshape(-1)
    n = u.numel()
    assert n == 2 ** 18
    assert u.min() >= 0 and u.max() < 1
    assert abs(u.mean().item() - 0.5) < 4 * (1 / 12 / n) ** 0.5
    z = (u - u.mean()) / u.std()
    for lag in (1, 4):
        corr = (z[:-lag] * z[lag:]).mean().item()
        assert abs(corr) < 4 / n ** 0.5, (lag, corr)


def test_generator_rounding_is_unbiased():
    """The mean of 64 quant-dequants under the Philox stream lies within a
    tenth of a level of x on average."""
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (8, 64), dtype=np.float32))
    gen = torch.Generator().manual_seed(0)
    mean = sum(q8.quant_dequant_plain(x, gen) for _ in range(64)) / 64
    level = x.abs().amax(-1, keepdim=True) / 127
    assert ((mean - x) / level).abs().mean() < 0.1


def test_vector_route_from_shape_and_alignment():
    """The kernel's 16-byte route: d a whole number of vectors (4 f32, 8
    bf16) and every pointer 16-byte aligned; the scalar route otherwise."""
    f32, bf16 = torch.float32, torch.bfloat16
    assert q8.vector_route(torch.zeros(4, 3072, dtype=f32))
    assert q8.vector_route(torch.zeros(4, 1600, dtype=f32))
    assert q8.vector_route(torch.zeros(4, 24, dtype=bf16))
    assert not q8.vector_route(torch.zeros(4, 1001, dtype=f32))
    assert not q8.vector_route(torch.zeros(4, 1004, dtype=bf16))
    buf = torch.zeros(4 * 3072 + 1)
    view = buf[1:].view(4, 3072)
    assert view.is_contiguous() and view.data_ptr() % 16
    assert not q8.vector_route(view)
    x = torch.zeros(4, 3072)
    assert q8.vector_route(x, torch.zeros(4, 3072), None)
    assert not q8.vector_route(x, view)
