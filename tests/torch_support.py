"""What the port's test files share: torch's thread pool held at one thread
for a module, and host models of the orders in which the ``slot_reduce``
kernel's bodies add.  Imports no JAX, so that ``test_torch_cuda.py`` can use
it on the card."""

import pytest
import torch

from pyslam_tpu_torch.solver import cuda_ops


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU ops in a test module are many and small: under the
    parallel test run, with every worker's thread pool on the same cores,
    they run ten times slower on torch's default threads than on one.
    Imported into a test module, it holds that module's tests to one
    thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the row stride J of the kernel's chunk sums
CHUNK_STRIDE = 8


def tiled_slot_sum(contrib, perm, offsets, n_slots, tile_rows, seq_rows):
    """``slot_reduce`` in the order of its kernel (csrc/slot_reduce.cu), on
    the host.  A segment of at most ``seq_rows`` rows is 0 + its rows one
    after the other in plan order.  A longer one of at most ``tile_rows``
    rows is one piece; a longer one still is cut into chunks of
    ``tile_rows`` rows at its first row, each a piece, and the pieces' sums
    are added in chunk order onto 0.  A piece's sum is 0 + S_0 + ... +
    S_{J-1}, where S_j = 0 + its rows j, j + J, j + 2J, ... and J =
    ``CHUNK_STRIDE``.  Exact in the bits: every addition is one IEEE
    addition of two values of contrib's dtype."""
    contrib = contrib.cpu()
    perm, offsets = perm.cpu().long(), offsets.cpu().long()
    C = contrib.shape[1]
    J = CHUNK_STRIDE
    n = offsets[1:] - offsets[:-1]
    chunks = torch.where(n > tile_rows, (n + tile_rows - 1) // tile_rows, torch.ones_like(n))
    seg = torch.repeat_interleave(torch.arange(n_slots), chunks)
    k = torch.arange(len(seg)) - torch.repeat_interleave(torch.cumsum(chunks, 0) - chunks, chunks)
    start = offsets[seg] + k * tile_rows
    length = torch.minimum(offsets[seg + 1] - start, torch.tensor(tile_rows))
    piece = torch.zeros((len(seg), C), dtype=contrib.dtype)
    short = n[seg] <= seq_rows
    for j in range(int(length.max()) if len(seg) else 0):  # short segments: one row after the other
        live = short & (length > j)
        piece[live] += contrib[perm[start[live] + j]]
    partial = torch.zeros((int((~short).sum()), J, C), dtype=contrib.dtype)
    lstart, llength = start[~short], length[~short]
    for j in range(J):  # the other pieces: S_j over rows j, j + J, ...
        for r in range(j, tile_rows, J):
            live = llength > r
            partial[live, j] += contrib[perm[lstart[live] + r]]
    piece_sums = torch.zeros((len(lstart), C), dtype=contrib.dtype)
    for j in range(J):
        piece_sums += partial[:, j]
    piece[~short] = piece_sums
    out = torch.zeros((n_slots, C), dtype=contrib.dtype)
    for kk in range(int(chunks.max()) if n_slots else 0):
        at = k == kk
        out[seg[at]] += piece[at]
    return out


def sequential_slot_sum(contrib, perm, offsets, n_slots):
    """Each segment's rows added one after the other in plan order onto 0,
    on the host."""
    n = offsets.cpu().long()[1:] - offsets.cpu().long()[:-1]
    longest = max(int(n.max()) if n_slots else 1, 1)
    return tiled_slot_sum(contrib, perm, offsets, n_slots, longest, longest)


def block_slot_sum(contrib, perm, offsets, n_slots, threads=1024):
    """``slot_reduce`` in the order of its block body, on the host: with Rb
    = threads // C rows in flight (1 past ``threads`` columns), partial sum
    r of a segment adds its rows r, r + Rb, ... one after the other onto 0,
    then the partial sums meet pairwise, the upper half onto the lower
    (h = the power of two below Rb, then h / 2, ..., 1: partial r += partial
    r + h for r < min(h, Rb - h))."""
    contrib = contrib.cpu()
    perm, offsets = perm.cpu().long(), offsets.cpu().long()
    E, C = contrib.shape
    Rb = max(threads // C, 1)
    n = offsets[1:] - offsets[:-1]
    seg = torch.repeat_interleave(torch.arange(n_slots), n)
    pos = torch.arange(E) - offsets[seg]
    r, k = pos % Rb, pos // Rb
    partial = torch.zeros((n_slots, Rb, C), dtype=contrib.dtype)
    rows = contrib[perm]
    for kk in range(int(k.max()) + 1 if E else 0):  # each (segment, r) once a round
        at = k == kk
        partial[seg[at], r[at]] += rows[at]
    h = 1
    while 2 * h < Rb:
        h *= 2
    while Rb > 1 and h >= 1:
        m = min(h, Rb - h)
        partial[:, :m] += partial[:, h:h + m]
        h //= 2
    return partial[:, 0]


def slot_reduce_model(contrib, perm, offsets, n_slots, longest=None):
    """``slot_reduce(contrib, perm, offsets, n_slots, longest)`` in the
    order of the body that ``cuda_ops.slot_reduce_body`` gives it, on the
    host, exact in the bits."""
    body = cuda_ops.slot_reduce_body(contrib.shape[0], n_slots, contrib.shape[1], longest)
    if body == "block":
        return block_slot_sum(contrib, perm, offsets, n_slots, cuda_ops.SLOT_BLOCK_THREADS)
    if body == "subwarps":
        return sequential_slot_sum(contrib, perm, offsets, n_slots)
    return tiled_slot_sum(contrib, perm, offsets, n_slots, cuda_ops.SLOT_TILE_ROWS, cuda_ops.SLOT_SEQ_ROWS)
