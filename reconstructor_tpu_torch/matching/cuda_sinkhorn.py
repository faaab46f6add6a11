"""Log-space Sinkhorn with dust bins: a hand-written CUDA kernel for Hopper.

Counterpart of ``reconstructor_tpu/matching/pallas_sinkhorn.py``: the TPU
package's Pallas ``_sinkhorn_kernel`` becomes ``csrc/sinkhorn.cu`` (whose
header says what bounds it on an H100 and how its design answers that),
built with ``nvcc`` for ``sm_90a`` at first use and called through
``ctypes``. On a chunk of B pairs it runs ``num_iters`` alternating
updates on the (M+1, N+1) augmented coupling C,
u = log_mu - LSE_row(C + v^T), then v = log_nu - LSE_col(C + u), and
returns C + u + v^T.

``log_sinkhorn_fused`` builds the coupling and the marginals exactly as
``pallas_sinkhorn.log_sinkhorn_fused`` does and subtracts the norm: the
JAX package's ``superglue.log_sinkhorn``. ``sinkhorn_kernel`` is the
wrapper: on a CUDA tensor it launches the kernel or raises; on a CPU
tensor it runs ``sinkhorn_plain``, the same loop in plain PyTorch, which
is also what the kernel is held against on the card.

The kernel loops over each pair's valid rows and columns only (masked
ones underflow to exactly 0 in every other logsumexp), for any mask, not
only prefixes; ``skip_plan`` states the per-pair index lists it builds
from the marginals. Masked entries must be as ``augment`` builds them:
-1e9 in log_mu / log_nu and in C outside the bins, alpha in the bins.
``plan`` picks the cluster size of a chunk shape once (cached in
``PLANS``).

Size: the kernel takes any chunk whose rows and columns index in 32 bits
and whose columns' state (20 bytes each) fits one block's shared memory:
N + 1 <= 8193, so every SuperGlue K up to 8192. Rows of a pair beyond what
its cluster's shared memory holds are read from device memory, which
costs time, not correctness. The JAX package's fallback to its XLA loop
above 12 MiB (``superglue.py:348-353``, ``pallas_sinkhorn.supported``) is
a limit of the TPU's VMEM and has no counterpart here: on the card the
kernel runs at every size ``supported`` accepts or raises.
"""

from __future__ import annotations

import ctypes

import torch

from reconstructor_tpu_torch.utils import cuda_build

SOURCE = "matching/csrc/sinkhorn.cu"
REPLACES = "reconstructor_tpu/matching/pallas_sinkhorn.py:32"   # _sinkhorn_kernel
_BIG_NEG = -1e9
_INDEX_LIMIT = 2 ** 31 - 1
MAX_N1 = 8193

# the launch plan of each (B, M1, N1, device index) chunk shape: cluster
# size, dynamic shared memory bytes, clusters resident at once and band
# rows held in shared memory when every slot is valid
PLANS: dict = {}
_VP, _CI = ctypes.c_void_p, ctypes.c_int
# couplings, log_mu, log_nu, B, M1, N1, iters, cluster, smem bytes, u, v,
# out, device index, stream
_FNS = {"sinkhorn_launch": [_VP, _VP, _VP, _CI, _CI, _CI, _CI, _CI, _CI, _VP, _VP, _VP, _CI, _VP],
        "sinkhorn_plan": [_CI, _CI, _CI, _CI, ctypes.POINTER(_CI)]}


def supported(B: int, M1: int, N1: int) -> bool:
    """Whether the kernel takes a (B, M1, N1) coupling."""
    return (B >= 1 and M1 >= 1 and 1 <= N1 <= MAX_N1
            and B * max(M1, N1) <= _INDEX_LIMIT)


def skip_plan(log_mu: torch.Tensor, log_nu: torch.Tensor):
    """The per-pair index lists of the kernel's loop, in plain PyTorch:
    (rows_idx (B, M1), n_rows (B,), cols_idx (B, N1), n_cols (B,)), int32.
    A row is valid where log_mu is above -1e9 / 2; rows_idx holds the
    valid rows in order (the bin, always valid, last among them), then the
    masked ones, and n_rows counts the valid ones. Columns likewise from
    log_nu. Each block of the kernel builds the same lists for its pair
    from the marginals by a block-wide prefix sum (the valid rows of its
    band, every valid column), so a launch costs no pass of its own."""
    def one(lm):
        valid = lm > _BIG_NEG / 2
        valid[:, -1] = True
        idx = torch.argsort((~valid).to(torch.int8), dim=1, stable=True)
        return idx.to(torch.int32).contiguous(), valid.sum(1).to(torch.int32)
    return one(log_mu) + one(log_nu)


def plan(B: int, M1: int, N1: int, device: torch.device) -> dict:
    """The launch of a (B, M1, N1) chunk on ``device`` (cached): cluster
    size, dynamic shared memory, clusters resident at once and band rows
    held in shared memory when every slot is valid."""
    key = (B, M1, N1, device.index)
    if key not in PLANS:
        lib = cuda_build.bind(SOURCE, _FNS, "sinkhorn_error_string")
        out = (_CI * 4)()
        cuda_build.check(lib, lib["sinkhorn_plan"](B, M1, N1, device.index, out),
                         f"sinkhorn: no launch for a ({B}, {M1}, {N1}) chunk")
        PLANS[key] = {"cluster": out[0], "smem_bytes": out[1], "active_clusters": out[2],
                      "cached_rows": out[3]}
    return PLANS[key]


def augment(scores: torch.Tensor, alpha: torch.Tensor, mask0: torch.Tensor,
            mask1: torch.Tensor):
    """The dust-bin coupling and marginals of ``pallas_sinkhorn.py:102-125``.

    scores (B, M, N); alpha scalar; masks (B, M) / (B, N). Returns
    (couplings (B, M+1, N+1), log_mu (B, M+1), log_nu (B, N+1), norm (B,)).
    """
    B, M, N = scores.shape
    dt = scores.dtype
    scores = torch.where(mask0[:, :, None] & mask1[:, None, :], scores, _BIG_NEG)
    a = alpha.to(dt)
    couplings = torch.cat([
        torch.cat([scores, a.expand(B, M, 1)], dim=2),
        torch.cat([a.expand(B, 1, N), a.expand(B, 1, 1)], dim=2),
    ], dim=1)
    m_eff = torch.sum(mask0, dim=1).to(dt)
    n_eff = torch.sum(mask1, dim=1).to(dt)
    norm = -torch.log(m_eff + n_eff + 1e-9)
    log_mu = torch.cat([torch.where(mask0, norm[:, None], _BIG_NEG),
                        (torch.log(n_eff + 1e-9) + norm)[:, None]], dim=1)
    log_nu = torch.cat([torch.where(mask1, norm[:, None], _BIG_NEG),
                        (torch.log(m_eff + 1e-9) + norm)[:, None]], dim=1)
    return couplings, log_mu, log_nu, norm


def sinkhorn_plain(couplings: torch.Tensor, log_mu: torch.Tensor, log_nu: torch.Tensor,
                   num_iters: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch: couplings (B, M1, N1),
    log_mu (B, M1), log_nu (B, N1). Returns couplings + u + v^T."""
    B, M1, N1 = couplings.shape
    u = torch.zeros((B, M1), dtype=couplings.dtype, device=couplings.device)
    v = torch.zeros((B, N1), dtype=couplings.dtype, device=couplings.device)
    for _ in range(num_iters):
        u = log_mu - torch.logsumexp(couplings + v[:, None, :], dim=2)
        v = log_nu - torch.logsumexp(couplings + u[:, :, None], dim=1)
    return couplings + u[:, :, None] + v[:, None, :]


def sinkhorn_kernel(couplings: torch.Tensor, log_mu: torch.Tensor, log_nu: torch.Tensor,
                    num_iters: int) -> torch.Tensor:
    """Run the Sinkhorn loop; see ``sinkhorn_plain``.

    On a CUDA tensor this launches ``csrc/sinkhorn.cu`` (or raises); the
    plain version runs only for tensors on the CPU.
    """
    if couplings.device.type == "cpu":
        return sinkhorn_plain(couplings, log_mu, log_nu, num_iters)
    if couplings.device.type != "cuda":
        raise ValueError(f"sinkhorn_kernel: unsupported device {couplings.device}")
    if couplings.dim() != 3:
        raise ValueError(f"sinkhorn_kernel: couplings must be (B, M1, N1), got {tuple(couplings.shape)}")
    B, M1, N1 = couplings.shape
    if not supported(B, M1, N1):
        raise ValueError(f"sinkhorn_kernel: a ({B}, {M1}, {N1}) coupling does not "
                         f"index in 32 bits or has more than {MAX_N1} columns")
    if num_iters < 0:
        raise ValueError(f"sinkhorn_kernel: num_iters must be >= 0, got {num_iters}")
    for name, t, shape in (("couplings", couplings, (B, M1, N1)), ("log_mu", log_mu, (B, M1)),
                           ("log_nu", log_nu, (B, N1))):
        if t.dtype != torch.float32:
            raise TypeError(f"sinkhorn_kernel: {name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"sinkhorn_kernel: {name} must be {shape}, got {tuple(t.shape)}")
        if t.device != couplings.device:
            raise ValueError(f"sinkhorn_kernel: {name} on {t.device}, couplings on {couplings.device}")
        if not t.is_contiguous():
            raise ValueError(f"sinkhorn_kernel: {name} must be contiguous")
    dev = couplings.device
    launch = plan(B, M1, N1, dev)
    out = torch.empty_like(couplings)
    u = torch.empty((B, M1), dtype=torch.float32, device=dev)
    v = torch.empty((B, N1), dtype=torch.float32, device=dev)
    args = (couplings.data_ptr(), log_mu.data_ptr(), log_nu.data_ptr(), B, M1, N1,
            int(num_iters), launch["cluster"], launch["smem_bytes"], u.data_ptr(), v.data_ptr(),
            out.data_ptr(), dev.index)
    cuda_build.launch(cuda_build.bind(SOURCE, _FNS, "sinkhorn_error_string"), "sinkhorn_launch",
                      args, dev)
    return out


def log_sinkhorn_fused(scores: torch.Tensor, alpha: torch.Tensor, mask0: torch.Tensor,
                       mask1: torch.Tensor, num_iters: int) -> torch.Tensor:
    """Optimal transport with dust bins (SuperGlue §3.2): the batched
    (B, M, N) scores in, the (B, M+1, N+1) log-coupling shifted by -norm
    out; masked slots couple only with the bins. The kernel on the card,
    the plain loop on the CPU."""
    couplings, log_mu, log_nu, norm = augment(scores, alpha, mask0, mask1)
    Z = sinkhorn_kernel(couplings, log_mu, log_nu, num_iters)
    return Z - norm[:, None, None]
