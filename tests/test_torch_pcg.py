"""``cuda_ops.ell_pcg`` of the torch port against the JAX reference's
``linear.pcg_solve``, in f64 on the CPU, on the same numpy inputs.

The reference side runs ``pcg_solve`` with the einsum ELL product
(``pyslam_tpu.solver.bcsr.ell_matvec``) and the block-Jacobi
preconditioner, as ``solve_ell`` does on the CPU.  On a CPU tensor the
port's wrapper runs its plain version (the host loop over the plain
product); the kernel itself is held against that plain version on the card
by ``tests/test_torch_cuda.py``.

A block of right-hand sides (nb*d, m) runs every column's recurrences at
once, each column with its own stop test, as the reference's vmap of
``pcg_solve`` over the columns of a covariance query: held to m single
solves and to that vmap.

Tolerances: x within 1e-10 of the largest reference entry (both sides run
the same recurrences in f64; only the order of the sums differs), the same
iteration count.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyslam_tpu.graph import build as jbuild
from pyslam_tpu.io import synth as jsynth
from pyslam_tpu.solver import bcsr as jb
from pyslam_tpu.solver.linear import pcg_solve as j_pcg_solve
from pyslam_tpu_torch.solver import cuda_ops
from pyslam_tpu_torch.solver.bcsr import sym_block_inv
from pyslam_tpu_torch.solver.cuda_ops import ell_pcg
from pyslam_tpu_torch.solver.linear import HOST_READS, reset_host_reads
from torch_support import one_torch_thread  # noqa: F401  (autouse: one torch thread a module)


def _sphere_system():
    """The Marquardt-damped He (lambda = 1e-4) and gradient of
    se3_sphere(60), assembled by the reference."""
    g = jbuild.pose_graph(jsynth.se3_sphere(n_poses=60, seed=11), dtype=jnp.float64)
    plan = jb.build_ell_direct(g)
    He, b, _ = jb.assemble_ell(g, plan)
    He = np.array(He)
    diag = np.maximum(np.einsum("rii->ri", He[:, 0]), 1e-12)
    He[:, 0] += 1e-4 * np.einsum("ri,ij->rij", diag, np.eye(He.shape[-1]))
    return He, np.asarray(plan.cols, np.int32), np.asarray(b)


def _random_system(nb=40, K=4, d=3, seed=3):
    """A random symmetric ELL matrix, diagonally dominant by blocks (so
    SPD): row r couples to K - 1 distinct other rows, each pair stored in
    both rows as a block and its transpose."""
    rng = np.random.default_rng(seed)
    He = np.zeros((nb, K, d, d))
    cols = np.tile(np.arange(nb, dtype=np.int32)[:, None], (1, K))
    fill = np.ones(nb, int)  # next free slot of each row
    for r in range(nb):
        for c in rng.permutation(nb):
            if fill[r] >= K:
                break
            if c == r or fill[c] >= K or c in cols[r, 1 : fill[r]]:
                continue
            B = 0.3 * rng.normal(size=(d, d))
            He[r, fill[r]], cols[r, fill[r]] = B, c
            He[c, fill[c]], cols[c, fill[c]] = B.T, r
            fill[r] += 1
            fill[c] += 1
    for r in range(nb):
        A = rng.normal(size=(d, d))
        He[r, 0] = A @ A.T + (1.0 + np.abs(He[r, 1:]).sum()) * np.eye(d)
    return He, cols, rng.normal(size=nb * d)


SYSTEMS = {"sphere60_damped": _sphere_system, "random_d3": _random_system}


def _reference(He, cols, b, rtol, max_iters):
    nb, _, d, _ = He.shape
    He_j = jnp.asarray(He)
    ell = types.SimpleNamespace(nb=nb, d=d, cols=jnp.asarray(cols))  # what ell_matvec reads of a plan
    Minv = jb.sym_block_inv(He_j[:, 0])
    x, it = j_pcg_solve(
        lambda v: jb.ell_matvec(He_j, ell, v),
        jnp.asarray(b),
        precond=lambda r: jnp.einsum("rij,rj->ri", Minv, r.reshape(nb, d)).reshape(-1),
        rtol=rtol,
        max_iters=max_iters,
    )
    return np.asarray(x), int(it)


def _port(He, cols, b, rtol, max_iters):
    He_t = torch.from_numpy(np.array(He, copy=True))
    Minv = sym_block_inv(He_t[:, 0]).contiguous()
    return ell_pcg(He_t, torch.from_numpy(cols), Minv, torch.from_numpy(np.array(b, copy=True)), rtol, max_iters)


@pytest.mark.parametrize("stop", ["tolerance", "max_iters"])
@pytest.mark.parametrize("system", sorted(SYSTEMS))
def test_ell_pcg_matches_reference(system, stop):
    He, cols, b = SYSTEMS[system]()
    rtol, max_iters = (1e-8, 500) if stop == "tolerance" else (1e-14, 7)
    x_ref, it_ref = _reference(He, cols, b, rtol, max_iters)
    cuda_ops.reset_launches()
    reset_host_reads()
    res = _port(He, cols, b, rtol, max_iters)
    assert (it_ref < max_iters) == (stop == "tolerance")
    assert res.iterations.dtype == torch.int32 and res.iterations.dim() == 0
    assert int(res.iterations) == it_ref
    assert res.resident_rows is None  # the plain version keeps nothing on chip
    assert cuda_ops.LAUNCHES["ell_pcg_plain"] == 1 and cuda_ops.LAUNCHES["ell_pcg"] == 0
    assert HOST_READS["pcg"] == it_ref + (stop == "tolerance")  # one stop test per iteration
    np.testing.assert_allclose(res.x.numpy(), x_ref, rtol=0, atol=1e-10 * np.abs(x_ref).max())
    # and it is a solution: the true residual meets the tolerance it stopped on
    if stop == "tolerance":
        nb, _, d, _ = He.shape
        Ax = np.einsum("rkij,rkj->ri", He, res.x.numpy().reshape(nb, d)[cols]).reshape(-1)
        assert np.linalg.norm(b - Ax) <= 10 * rtol * np.linalg.norm(b)


@pytest.mark.parametrize("system", sorted(SYSTEMS))
def test_ell_pcg_nan_rhs_gives_nan_and_no_iteration(system):
    """A NaN in b makes the first stop test false on both sides: count 0.
    The reference's x0 - free r0 = b - A 0 is NaN too, and its x stays x0;
    what LM needs is that no iteration runs and nothing traps."""
    He, cols, b = SYSTEMS[system]()
    b = b.copy()
    b[5] = np.nan
    _, it_ref = _reference(He, cols, b, 1e-8, 50)
    res = _port(He, cols, b, 1e-8, 50)
    assert it_ref == 0 and int(res.iterations) == 0


@pytest.mark.parametrize("system", sorted(SYSTEMS))
def test_ell_pcg_nan_matrix_gives_nan_step(system):
    """A NaN in He (a failed preconditioner or assembly) comes out as a
    NaN or unchanged step with no trap, on both sides the same count."""
    He, cols, b = SYSTEMS[system]()
    He = He.copy()
    He[2, 0, 0, 0] = np.nan
    x_ref, it_ref = _reference(He, cols, b, 1e-8, 50)
    res = _port(He, cols, b, 1e-8, 50)
    assert int(res.iterations) == it_ref
    np.testing.assert_array_equal(np.isnan(res.x.numpy()), np.isnan(x_ref))


def test_ell_pcg_zero_rhs_and_zero_budget():
    He, cols, b = _random_system()
    res = _port(He, cols, np.zeros_like(b), 1e-8, 50)
    assert int(res.iterations) == 0 and not res.x.any()
    res = _port(He, cols, b, 1e-8, 0)
    assert int(res.iterations) == 0 and not res.x.any()


@pytest.mark.parametrize(
    "bad,match",
    [
        (dict(Minv=lambda m: m[:-1]), "Minv: shape"),
        (dict(b=lambda b: b.to(torch.float32)), "b: dtype"),
        (dict(cols=lambda c: c.long()), "cols: dtype"),
        (dict(He=lambda h: h.transpose(2, 3)), "He: not contiguous"),
        (dict(max_iters=lambda m: -1), "max_iters"),
    ],
)
def test_ell_pcg_refuses_what_the_kernel_does_not_take(bad, match):
    He, cols, b = _random_system()
    He_t = torch.from_numpy(He)
    args = dict(He=He_t, cols=torch.from_numpy(cols), Minv=sym_block_inv(He_t[:, 0]).contiguous(),
                b=torch.from_numpy(b), rtol=1e-8, max_iters=10)
    for k, f in bad.items():
        args[k] = f(args[k])
    with pytest.raises((TypeError, ValueError), match=match):
        ell_pcg(**args)


# --------------------------------------------------------------------------
# A block of right-hand sides
# --------------------------------------------------------------------------


def _columns(b, m=6, seed=4):
    """m right-hand sides that stop at different iterations: b itself, unit
    vectors (covariance columns), b scaled by 1e3 (the same iterations as b:
    the stop test is relative), a zero column (stops before the first
    iteration) and random ones."""
    n = b.shape[0]
    rng = np.random.default_rng(seed)
    B = rng.normal(size=(n, m))
    B[:, 0] = b
    B[:, 1] = np.eye(n)[0]
    B[:, 2] = np.eye(n)[n // 2]
    B[:, 3] = 1e3 * b
    B[:, 4] = 0.0
    return B


@pytest.mark.parametrize("system", sorted(SYSTEMS))
def test_ell_pcg_block_matches_single_solves_and_reference(system):
    """Each column of a block runs its own recurrences and stop test: the
    iterations of m single solves, x within 1e-10 of each (the block sums
    its dot products in another order), and of the reference's vmap of
    ``pcg_solve``.  The zero column stops at once, x = 0."""
    He, cols, b = SYSTEMS[system]()
    B = _columns(b)
    rtol, max_iters = 1e-10, 500
    cuda_ops.reset_launches()
    reset_host_reads()
    res = _port(He, cols, B, rtol, max_iters)
    assert res.x.shape == B.shape and res.iterations.shape == (B.shape[1],)
    assert res.iterations.dtype == torch.int32
    assert cuda_ops.LAUNCHES["ell_pcg_plain"] == 1
    its = res.iterations.tolist()
    assert HOST_READS["pcg"] == max(its) + 1  # one read of the m stop tests an iteration
    singles = [_port(He, cols, B[:, j].copy(), rtol, max_iters) for j in range(B.shape[1])]
    assert its == [int(s.iterations) for s in singles]
    assert its[4] == 0 and not res.x[:, 4].any() and its[0] == its[3]
    assert len(set(its)) > 1  # the columns stop at different iterations
    for j, s in enumerate(singles):
        np.testing.assert_allclose(res.x[:, j].numpy(), s.x.numpy(), rtol=0,
                                   atol=1e-10 * max(np.abs(s.x.numpy()).max(), 1e-300))
    nb, _, d, _ = He.shape
    He_j = jnp.asarray(He)
    ell = types.SimpleNamespace(nb=nb, d=d, cols=jnp.asarray(cols))
    Minv = jb.sym_block_inv(He_j[:, 0])
    ref_x, ref_it = jax.vmap(
        lambda v: j_pcg_solve(lambda u: jb.ell_matvec(He_j, ell, u), v,
                              precond=lambda r: jnp.einsum("rij,rj->ri", Minv, r.reshape(nb, d)).reshape(-1),
                              rtol=rtol, max_iters=max_iters), in_axes=1, out_axes=(1, 0))(jnp.asarray(B))
    assert its == np.asarray(ref_it).tolist()
    np.testing.assert_allclose(res.x.numpy(), np.asarray(ref_x), rtol=0, atol=1e-10 * np.abs(np.asarray(ref_x)).max())


def test_ell_pcg_block_budget_and_nan_column():
    """The budget caps every column; a NaN column stops before its first
    iteration without touching the others."""
    He, cols, b = _random_system()
    B = _columns(b)
    res = _port(He, cols, B, 1e-14, 3)
    assert res.iterations.tolist() == [3, 3, 3, 3, 0, 3]
    B[7, 5] = np.nan
    res = _port(He, cols, B, 1e-8, 50)
    clean = _port(He, cols, B[:, :5].copy(), 1e-8, 50)
    assert int(res.iterations[5]) == 0 and res.iterations[:5].tolist() == clean.iterations.tolist()
    np.testing.assert_allclose(res.x[:, :5].numpy(), clean.x.numpy(), rtol=0, atol=1e-12 * np.abs(clean.x.numpy()).max())


def test_ell_pcg_block_shapes_refused():
    He, cols, b = _random_system()
    He_t = torch.from_numpy(He)
    Minv = sym_block_inv(He_t[:, 0]).contiguous()
    for bad in (torch.zeros(b.shape[0] + 1, 2, dtype=torch.float64), torch.zeros(b.shape[0], 2, 1, dtype=torch.float64)):
        with pytest.raises(ValueError, match="b: shape"):
            ell_pcg(He_t, torch.from_numpy(cols), Minv, bad, 1e-8, 10)


def test_ell_pcg_kernel_layout_sizes():
    """The kernel's layout of a block: whole 16 bytes of columns (4 in f32,
    2 in f64), one column as it is; its scratch a 128-byte line a slot and
    a column total of the two barriers, the prologue's partial sums (2 grid
    mp), p twice and z (3 n mp; one column's tagged, 6 n)."""
    assert [cuda_ops.pcg_layout_columns(m, torch.float32) for m in (1, 2, 4, 5, 36, 37)] == [1, 4, 4, 8, 36, 40]
    assert [cuda_ops.pcg_layout_columns(m, torch.float64) for m in (1, 2, 3, 36, 43, 44)] == [1, 2, 4, 36, 44, 44]
    assert cuda_ops.pcg_scratch_values(15000, 36, 132, torch.float64) == (32 * 133 + 2 * 132) * 36 + 3 * 15000 * 36
    assert cuda_ops.pcg_scratch_values(15000, 1, 132, torch.float32) == 64 * 133 + 2 * 132 + 6 * 15000
