"""K20 ``ml_finalize``: the ML aggregates' models from their states.

The reference's finalizes (``presto_tpu/ops/aggregate.py``):

- ``learn_regressor`` (:1506): the weights solving ``(X'X + 1e-8 I) w =
  X'y``, ``dim = k + 1`` (the bias last), as ``[dim, w...]``.  The
  reference calls ``jnp.linalg.solve``; the port runs its own Gaussian
  elimination with partial pivoting (the first row of greatest
  ``|a|``; each step's multiplier ``f = a[r][c] / a[c][c]``, then
  ``a[r][j] - f * a[c][j]`` from column ``c`` on, and ``b[r] - f *
  b[c]``) and back substitution (``(b[r] - a[r][r+1] w[r+1] - ...) /
  a[r][r]``, left to right), the same steps in the same order on the
  card and in the twin, so the two agree bit for bit;
- ``learn_classifier`` (:1517): ``[1 + C (1 + 2k), C, prior, mean,
  var]`` with ``prior = counts / max(sum(counts), 1)``, ``mean = sumx /
  max(counts, 1)`` and ``var = max(sumx2 / max(counts, 1) - mean^2,
  1e-9)``;
- ``evaluate_classifier_predictions`` (:1541) passes its count matrix
  through to the executor's host finalize (no kernel).

CUDA tensors launch ``csrc/ml_finalize.cu`` (one thread per group);
CPU tensors run :func:`ml_finalize_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from presto_tpu_torch.kernels import build
from presto_tpu_torch.kernels import ml_state as k19

REGRESSOR, CLASSIFIER = range(2)
C = 8  # ops/aggregate.ML_MAX_CLASSES
MAX_DIM = 17  # csrc/ml_finalize.cu K20_MAX_DIM: sixteen features and the bias

launches = 0
#: launches by mode name
mode_launches: dict = {}


def width(mode: int, k: int) -> int:
    """The model row's width, its length slot included."""
    return 2 + k if mode == REGRESSOR else 2 + C * (1 + 2 * k)


def _solve_plain(s: torch.Tensor, k: int) -> torch.Tensor:
    n, dim = s.shape[0], k + 1
    dev = s.device
    eye = torch.eye(dim, dtype=torch.float64, device=dev) * 1e-8
    a = s[:, 1:1 + dim * dim].reshape(n, dim, dim) + eye
    b = s[:, 1 + dim * dim:1 + dim * dim + dim].clone()
    ar = torch.arange(n, device=dev)
    for col in range(dim):
        piv = torch.full((n,), col, dtype=torch.int64, device=dev)
        for r in range(col + 1, dim):
            take = torch.abs(a[:, r, col]) > torch.abs(a[ar, piv, col])
            piv = torch.where(take, torch.full_like(piv, r), piv)
        row_c, row_p = a[:, col].clone(), a[ar, piv].clone()
        a[:, col], a[ar, piv] = row_p, row_c
        b_c, b_p = b[:, col].clone(), b[ar, piv].clone()
        b[:, col], b[ar, piv] = b_p, b_c
        for r in range(col + 1, dim):
            f = a[:, r, col] / a[:, col, col]
            for j in range(col, dim):
                a[:, r, j] = a[:, r, j] - f * a[:, col, j]
            b[:, r] = b[:, r] - f * b[:, col]
    w = torch.zeros((n, dim), dtype=torch.float64, device=dev)
    for r in reversed(range(dim)):
        acc = b[:, r]
        for j in range(r + 1, dim):
            acc = acc - a[:, r, j] * w[:, j]
        w[:, r] = acc / a[:, r, r]
    return torch.cat([torch.full((n, 1), float(dim), dtype=torch.float64, device=dev), w], 1)


def _naive_bayes_plain(s: torch.Tensor, k: int) -> torch.Tensor:
    n, dev = s.shape[0], s.device
    counts = s[:, 1:1 + C]
    sumx = s[:, 1 + C:1 + C + C * k].reshape(n, C, k)
    sumx2 = s[:, 1 + C + C * k:1 + C + 2 * C * k].reshape(n, C, k)
    total = torch.zeros(n, dtype=torch.float64, device=dev)
    for c in range(C):
        total = total + counts[:, c]
    prior = counts / torch.clamp(total, min=1.0)[:, None]
    cc = torch.clamp(counts, min=1.0)[:, :, None]
    mean = sumx / cc
    var = torch.clamp(sumx2 / cc - mean * mean, min=1e-9)
    head = torch.tensor([1.0 + C * (1 + 2 * k), float(C)], dtype=torch.float64, device=dev)
    return torch.cat([head[None, :].expand(n, 2), prior, mean.reshape(n, C * k),
                      var.reshape(n, C * k)], 1)


def ml_finalize_plain(mode: int, state: torch.Tensor, k: int) -> torch.Tensor:
    return _solve_plain(state, k) if mode == REGRESSOR else _naive_bayes_plain(state, k)


def ml_finalize(mode: int, state: torch.Tensor, k: int) -> torch.Tensor:
    """The ``(groups, width(mode, k))`` float64 models of the partial
    states ``state`` (K19's layout: slot 0, then the lanes).  CPU tensors
    take the plain version; CUDA tensors launch the kernel."""
    global launches
    if mode not in (REGRESSOR, CLASSIFIER):
        raise ValueError(f"ml_finalize: mode {mode}")
    m = k19.lanes(k19.REGRESSOR if mode == REGRESSOR else k19.CLASSIFIER, k)
    if state.dim() != 2 or state.dtype != torch.float64 or state.shape[1] != 1 + m \
            or not 1 <= k < MAX_DIM:
        raise ValueError(f"ml_finalize: states must be (groups, {1 + m}) float64, "
                         f"1 <= k < {MAX_DIM}")
    if not state.is_cuda:
        return ml_finalize_plain(mode, state, k)
    build.require_cuda([state], "ml_finalize")
    g = state.shape[0]
    out = torch.empty((g, width(mode, k)), dtype=torch.float64, device=state.device)
    fn = build.library().k20_ml_finalize
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p]
    err = fn(mode, g, k, state.data_ptr(), out.data_ptr(), build.stream_of(state))
    build.check(err, "ml_finalize")
    launches += 1
    name = ("regressor", "classifier")[mode]
    mode_launches[name] = mode_launches.get(name, 0) + 1
    return out
