"""Training-style demo: learn A's values through the differentiable SpMM.

The port's twin of ``examples/train_sparse.py``: recovers the values of a
sparse matrix from (B, C_target) pairs by gradient descent on
||alpha*A(vals)@B + beta*C0 - C_target||^2, through the SDDMM gradient
(``sextans_tpu_torch/ops/autodiff.py``): dvals = alpha * (G @ B^T) sampled
at A's pattern. The same sizes and seeds; ``torch.optim.Adam`` in place of
optax; the values start from zeros.

Usage: python examples/train_sparse_torch.py [--device cpu]   (default: cuda)
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import sextans_tpu_torch as sx  # noqa: E402


def main(argv=None) -> float:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    device = torch.device(args.device)

    rng = np.random.default_rng(0)
    m, k, n, nnz = 256, 192, 32, 2000
    a_true = sx.COOMatrix.random(m, k, nnz, seed=1)
    cfg = sx.SpmmConfig(tile_m=64, window_k=64, block_k=8, group_blocks=16,
                        tile_n=128)
    # structure is fixed; values are the learned parameter
    op = sx.spmm_value_op(a_true, n, config=cfg, device=device)

    b = torch.as_tensor(rng.standard_normal((k, n)).astype(np.float32), device=device)
    c0 = torch.as_tensor(rng.standard_normal((m, n)).astype(np.float32), device=device)
    alpha, beta = 1.0, 0.5
    true_vals = torch.as_tensor(a_true.vals, device=device)
    with torch.no_grad():
        target = op(true_vals, b, c0, alpha, beta)

    def loss_fn(vals):
        pred = op(vals, b, c0, alpha, beta)
        return torch.mean((pred - target) ** 2)

    vals = torch.zeros(a_true.nnz, dtype=torch.float32, device=device, requires_grad=True)
    opt = torch.optim.Adam([vals], lr=0.1)  # start from nothing
    for step in range(300):
        opt.zero_grad()
        loss = loss_fn(vals)
        loss.backward()
        opt.step()
        if step % 50 == 0:
            print(f"step {step:3d}  loss {loss.item():.3e}")
    with torch.no_grad():
        final = loss_fn(vals).item()
        err = (vals - true_vals).abs().max().item()
    print(f"final loss {final:.3e}, max |vals - true| = {err:.3e}")
    if not final < 1e-4:  # the JAX example's assertion, kept under python -O
        raise AssertionError(f"loss {final:.3e} did not reach 1e-4")
    print("recovered A's values through the SDDMM gradient — OK")
    return final


if __name__ == "__main__":
    main()
