"""PCG's 3 x 3 point-block products (``ba/cuda_blocks.py``, kernel 8).

On the CPU: the plain version (the wrapper's CPU route) against the einsum
the solver ran before it, on the strided (L, 3, 3) view of ``_inv3x3``'s
(9, L) planes, bit for bit, and against a float64 H^-1 v; the wrapper's
CPU route (the plain version, no launch); and ``block3_matvec_reference``,
the kernel's fixed order in float64, against the same order in exact
rational arithmetic. On the card (``cuda``-marked, skipped here): the
kernel against that reference and, at the benchmark's L, against the
card's einsum, bit for bit, and a PCG solve through it against the same
solve through the reference. This file does not import JAX, so on the
card

    python -m pytest -q --noconftest -m cuda tests/test_torch_point_blocks.py

runs it."""

import math
from fractions import Fraction

import numpy as np
import pytest
import torch

from reconstructor_tpu_torch.ba import cuda_blocks, distributed, lm as ba_lm
from reconstructor_tpu_torch.utils import cuda_build


def bits(x: torch.Tensor) -> torch.Tensor:
    """The float32 values' bit patterns (tells -0 from 0, compares NaNs)."""
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("L", [0, 1, 7, 4097])
def test_plain_equals_the_einsum_it_replaces(L):
    """``_inv3x3``'s planes through ``block3_matvec_plain`` give what the
    solver computed on the (L, 3, 3) view it kept before, bit for bit, and
    H^-1 v within float32 rounding of a float64 solve."""
    rng = np.random.default_rng(L)
    B = rng.standard_normal((L, 3, 3)).astype(np.float32)
    H = torch.from_numpy(B @ B.transpose(0, 2, 1) + np.eye(3, dtype=np.float32))
    v = torch.from_numpy(rng.standard_normal((L, 3)).astype(np.float32))
    got = cuda_blocks.block3_matvec_plain(distributed._inv3x3(H), v)
    before = ba_lm._inv3x3_soa(H.reshape(L, 9).T).T.reshape(L, 3, 3)
    assert torch.equal(bits(got), bits(torch.einsum("lij,lj->li", before, v)))
    want = torch.linalg.solve(H.double(), v.double()[:, :, None])[:, :, 0]
    scale = want.abs().amax(1, keepdim=True).clamp(min=1e-30)
    assert bool(((got.double() - want).abs() / scale < 1e-4).all())


def test_cpu_takes_the_plain_route():
    """``_inv3x3`` leaves contiguous (9, L) planes; the wrapper runs the
    plain version on CPU tensors and counts no launch."""
    rng = np.random.default_rng(3)
    H = torch.from_numpy(rng.standard_normal((33, 3, 3)).astype(np.float32))
    h9 = distributed._inv3x3(H)
    assert h9.shape == (9, 33) and h9.is_contiguous()
    v = torch.from_numpy(rng.standard_normal((33, 3)).astype(np.float32))
    cuda_build.reset_launches()
    got = cuda_blocks.block3_matvec(h9, v)
    assert torch.equal(bits(got), bits(cuda_blocks.block3_matvec_plain(h9, v)))
    assert cuda_build.launches()["block3_matvec_launch"] == 0
    with pytest.raises(ValueError):
        cuda_blocks.block3_matvec(torch.zeros(9, 2, device="meta"),
                                  torch.zeros(2, 3, device="meta"))


def round32(q: Fraction) -> Fraction:
    """q rounded to float32 (nearest, ties to even, subnormals; no
    overflow in these cases)."""
    if q == 0:
        return Fraction(0)
    e = max(math.floor(math.log2(abs(q))), -126)
    while Fraction(2) ** e > abs(q) and e > -126:    # log2's float may be one off
        e -= 1
    while Fraction(2) ** (e + 1) <= abs(q):
        e += 1
    ulp = Fraction(2) ** (max(e, -126) - 23)
    n, r = divmod(q / ulp, 1)
    if r > Fraction(1, 2) or (r == Fraction(1, 2) and n % 2):
        n += 1
    return n * ulp


def exact_order(h9: np.ndarray, v: np.ndarray) -> np.ndarray:
    """(fma(a1, x1, a0 x0) + a2 x2) + 0 in rationals, each step rounded
    once to float32."""
    out = np.zeros(v.shape, np.float32)
    for l in range(v.shape[0]):
        x = [Fraction(float(t)) for t in v[l]]
        for i in range(3):
            a = [Fraction(float(t)) for t in h9[3 * i:3 * i + 3, l]]
            t = round32(a[1] * x[1] + round32(a[0] * x[0]))
            out[l, i] = float(round32(t + round32(a[2] * x[2])))   # + 0: -0 never made
    return out


def huge_tiny_np(shape, rng) -> np.ndarray:
    """Entries of magnitudes 2^-75 .. 2^60, with 3% zeros and 3% negative
    zeros."""
    x = rng.standard_normal(shape) * np.exp2(rng.integers(-75, 60, shape))
    u = rng.random(shape)
    x = np.where(u < 0.03, 0.0, x)
    return np.where(u > 0.97, -0.0, x).astype(np.float32)


def double_rounding_case() -> tuple:
    """One landmark whose fma, 1 + 2^-23 - 2^-24 (1 + 2^-23)(1 - 2^-23) =
    1 + 2^-24 + 2^-70, lies just above a float32 midpoint: rounded to
    float64 first it would land on the midpoint and round to 1, rounded
    once it is 1 + 2^-23."""
    h9 = np.zeros((9, 1), np.float32)
    h9[0:2, 0] = [1 + 2.0 ** -23, -(2.0 ** -24) * (1 + 2.0 ** -23)]
    v = np.array([[1.0, 1 - 2.0 ** -23, 0.0]], np.float32)
    return h9, v


@pytest.mark.parametrize("case", ["random", "huge_tiny", "double_rounding"])
def test_reference_is_the_fixed_order(case):
    """``block3_matvec_reference`` (float64, each rounding explicit)
    equals the kernel's order computed in rationals, bit for bit."""
    rng = np.random.default_rng(11)
    if case == "random":
        h9 = rng.standard_normal((9, 200)).astype(np.float32)
        v = (rng.standard_normal((200, 3)) * np.exp2(rng.integers(-10, 10, (200, 1)))
             ).astype(np.float32)
    elif case == "huge_tiny":
        h9, v = huge_tiny_np((9, 200), rng), huge_tiny_np((200, 3), rng)
    else:
        h9, v = double_rounding_case()
    got = cuda_blocks.block3_matvec_reference(torch.from_numpy(h9), torch.from_numpy(v))
    assert got.dtype == torch.float32 and got.shape == v.shape
    assert torch.equal(bits(got), bits(torch.from_numpy(exact_order(h9, v))))
    if case == "double_rounding":
        assert float(got[0, 0]) == 1 + 2.0 ** -23


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


def spd_planes(L: int, g: torch.Generator, dev) -> torch.Tensor:
    """(9, L) planes of the inverses of random SPD blocks, as ``_inv3x3``."""
    B = torch.randn(L, 3, 3, generator=g, device=dev)
    H = B @ B.transpose(1, 2) + 0.1 * torch.eye(3, device=dev)
    return distributed._inv3x3(H)


def huge_tiny(shape, g: torch.Generator, dev) -> torch.Tensor:
    """Entries of magnitudes 2^-75 .. 2^60 (products that overflow nothing
    and underflow into subnormals), with 3% zeros and 3% negative zeros."""
    x = torch.randn(*shape, generator=g, device=dev)
    x = x * torch.exp2(torch.randint(-75, 60, shape, generator=g, device=dev).float())
    u = torch.rand(*shape, generator=g, device=dev)
    x = torch.where(u < 0.03, torch.zeros_like(x), x)
    return torch.where(u > 0.97, -torch.zeros_like(x), x)


@pytest.mark.cuda
@pytest.mark.parametrize("L", [0, 1, 31, 1_000_003, 8_388_608])
def test_kernel_equals_the_reference(card, L):
    """Kernel 8 == ``block3_matvec_reference`` bit for bit, on random SPD
    inverses, on huge and tiny entries and on a sum just above a float32
    midpoint; three calls equal."""
    g = torch.Generator(device=card)
    g.manual_seed(L)
    scale = torch.exp2(torch.randint(-10, 10, (L, 1), generator=g, device=card).float())
    h9_dr, v_dr = (torch.from_numpy(a).to(card) for a in double_rounding_case())
    cases = {"spd": (spd_planes(L, g, card), torch.randn(L, 3, generator=g, device=card) * scale),
             "huge_tiny": (huge_tiny((9, L), g, card), huge_tiny((L, 3), g, card)),
             "double_rounding": (torch.cat([h9_dr.expand(9, L), h9_dr], 1).contiguous(),
                                 torch.cat([v_dr.expand(L, 3), v_dr]).contiguous())}
    for name, (h9, v) in cases.items():
        want = bits(cuda_blocks.block3_matvec_reference(h9, v))
        cuda_build.reset_launches()
        got = [cuda_blocks.block3_matvec(h9, v) for _ in range(3)]
        torch.cuda.synchronize(card)
        assert cuda_build.launches()["block3_matvec_launch"] == (3 if h9.shape[1] else 0)
        for out in got:
            assert out.shape == v.shape
            n = int((bits(out) != want).sum())
            assert n == 0, f"{name}, L={L}: {n} of {v.numel()} values differ from the reference"


@pytest.mark.cuda
@pytest.mark.parametrize("L", [1_048_576, 8_388_608])
def test_kernel_equals_the_card_einsum(card, L):
    """At the PCG cells' L (Venice, Final-13682) kernel 8 equals the einsum
    it replaced there, on the same strided view, bit for bit: the solves
    the benchmark times take the same steps."""
    g = torch.Generator(device=card)
    g.manual_seed(L)
    h9, v = spd_planes(L, g, card), torch.randn(L, 3, generator=g, device=card)
    n = int((bits(cuda_blocks.block3_matvec(h9, v))
             != bits(cuda_blocks.block3_matvec_plain(h9, v))).sum())
    assert n == 0, f"L={L}: {n} of {3 * L} values differ from the einsum's"


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(card):
    h9 = torch.zeros(9, 8, device=card)
    v = torch.zeros(8, 3, device=card)
    with pytest.raises(TypeError):
        cuda_blocks.block3_matvec(h9.double(), v.double())
    with pytest.raises(TypeError):
        cuda_blocks.block3_matvec(h9, v.double())
    for bad_h9, bad_v in ((h9[:8], v), (h9, v[:7]), (h9.reshape(8, 9), v),
                          (h9, v.cpu()),
                          (torch.zeros(8, 9, device=card).T, v),
                          (h9, torch.zeros(3, 8, device=card).T)):
        with pytest.raises(ValueError):
            cuda_blocks.block3_matvec(bad_h9, bad_v)


@pytest.mark.cuda
def test_pcg_solve_through_kernel_8(card, monkeypatch):
    """A PCG solve of the fountain problem on the card launches kernel 8
    once every CG iteration and twice a trial, and ends in the state the
    same solve reaches through ``block3_matvec_reference``, bit for bit."""
    from reconstructor_tpu_torch.scripts import exp_ba
    prob = exp_ba.load_problem(device=card)
    counts = {"matvecs": 0, "trials": 0}
    matvec, step = distributed._schur_matvec, distributed._lm_step_pcg

    def counted_matvec(*a, **k):
        counts["matvecs"] += 1
        return matvec(*a, **k)

    def counted_step(*a, **k):
        counts["trials"] += 1
        return step(*a, **k)
    monkeypatch.setattr(distributed, "_schur_matvec", counted_matvec)
    monkeypatch.setattr(distributed, "_lm_step_pcg", counted_step)
    kw = dict(max_iters=10, huber_delta=3.0)
    cuda_build.reset_launches()
    kernel = distributed.solve_pcg(prob, **kw)
    torch.cuda.synchronize(card)
    assert counts["trials"] > 0 and counts["matvecs"] > counts["trials"]
    assert cuda_build.launches()["block3_matvec_launch"] == (counts["matvecs"]
                                                             + 2 * counts["trials"])
    monkeypatch.setattr(cuda_blocks, "block3_matvec", cuda_blocks.block3_matvec_reference)
    ref = distributed.solve_pcg(prob, **kw)
    assert kernel.iterations == ref.iterations
    for a, b in ((kernel.cam_params, ref.cam_params), (kernel.points, ref.points),
                 (kernel.cost_final, ref.cost_final)):
        assert torch.equal(bits(a), bits(b))
