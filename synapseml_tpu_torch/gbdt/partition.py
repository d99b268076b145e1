"""The row partition of a tree on the device (kernel P).

Port of the leaf-local branch of ``synapseml_tpu/gbdt/grow.py::grow_tree``
(``:196-250``, ``:384-408``), in the form LightGBM's ``DataPartition`` (and
XGBoost's ``RowPartitioner``) keeps it: the rows' ids grouped by leaf, so
that a growth step reads only the rows of the leaf it splits, and histograms
only the smaller child's (kernel A's row-list entry,
:func:`~.histogram.histogram_rows`).

:class:`RowPartition` holds, for the tree being grown:

- ``ids`` (2, n) int32, two buffers of row ids; each leaf's rows are one
  slice of one of them;
- ``seg`` (L, 2) int32, each leaf's (begin, count) slice, and ``side`` (L,)
  int32, the buffer (0 or 1) that holds it (:meth:`RowPartition.rows`);
- ``small`` (3,) int32, the (begin, count, buffer) of the last step's
  smaller child, and ``smaller_right`` (1,) bool, whether that child is the
  right one;
- ``counts`` (2,) int32, the mesh entry's (left, right) rows of the last
  step.

:meth:`RowPartition.split` runs one step after kernel E's decision (its
``choice``, ``ok`` and ``in_set``, read on the device): the split leaf's
rows go left iff ``in_set[bins[row, feature]]``, right rows get
``node = s + 1``, and both children are written into the same range of the
other buffer (left rows first), so nothing is copied back; ``seg`` gains the
new leaf, ``side`` names the other buffer for both children, and the smaller
child is the right one iff its member count (weight 0 included) is at most
the left's, the reference's rule (``grow.py:397``). An inert step changes
nothing and records an empty smaller child on the right. On CUDA tensors
this is one launch of ``csrc/partition.cu``, and nothing is read back to
the host; on CPU tensors it is :func:`partition_plain`, a stable
boolean-mask partition into the same buffer. The kernel does not keep the
order of rows inside a leaf: histogram sums on ``boost._preround``'s grid
are exact in any order.

On a data-parallel mesh (``split(..., mesh=True)``, kernel P's mesh entry)
the smaller child is the one with fewer rows over every rank: the launch
routes and counts as above but writes this rank's ``(n_left, n_right)``
into ``counts`` and chooses nothing; the grower all-reduces ``counts``
(one collective of two int32) and :meth:`RowPartition.pick` (a second,
one-thread launch, ``smt_partition_pick``; :func:`pick_plain` on the CPU)
sets ``smaller_right`` from the global counts and ``small`` to that
child's local slice.
"""

from __future__ import annotations

import ctypes

import torch

from ..kernels.build import CudaKernel

__all__ = ["RowPartition", "partition_plain", "pick_plain", "PARTITION_KERNEL",
           "PARTITION_MESH_KERNEL", "PARTITION_PICK_KERNEL", "PARTITION_TRACE",
           "PARTITION_PICK_TRACE"]

_BIN_DTYPES = (torch.int8, torch.int16, torch.int32)
_POINTERS = ("bins", "ids", "seg", "side", "counters", "node", "choice", "ok", "in_set",
             "small", "smaller_right", "counts")

class _PartArgs(ctypes.Structure):
    """``PartArgs`` of ``csrc/partition.cu``, field for field."""

    _fields_ = ([(name, ctypes.c_void_p) for name in _POINTERS]
                + [("n", ctypes.c_longlong), ("d", ctypes.c_int), ("n_bins", ctypes.c_int),
                   ("s", ctypes.c_int), ("device", ctypes.c_int), ("mesh", ctypes.c_int)])


PARTITION_KERNEL = CudaKernel(
    name="gbdt_partition", source="partition", symbol="smt_partition",
    argtypes=[ctypes.POINTER(_PartArgs), ctypes.c_int, ctypes.c_void_p],
    replaces="synapseml_tpu/gbdt/grow.py:384 (the step's routing, member counts and "
             "smaller-child choice :384-403, feeding leaf_hist_local :223-250)")
# the mesh entry: the same launch with mesh = 1 (counts out, no side
# chosen), counted apart, and its one-thread pick after the counts'
# all-reduce
PARTITION_MESH_KERNEL = CudaKernel(
    name="gbdt_partition_mesh", source="partition", symbol="smt_partition",
    argtypes=[ctypes.POINTER(_PartArgs), ctypes.c_int, ctypes.c_void_p],
    replaces="synapseml_tpu/gbdt/grow.py:384 (the step's routing and member counts "
             ":384-392, whose counts the mesh psums, :393-396)")
PARTITION_PICK_KERNEL = CudaKernel(
    name="gbdt_partition_pick", source="partition", symbol="smt_partition_pick",
    argtypes=[ctypes.POINTER(_PartArgs), ctypes.c_void_p],
    replaces="synapseml_tpu/gbdt/grow.py:397 (the smaller child from the psum'd "
             "counts, :397-403)")
# the kernels' names in a profiler trace, as substrings that the name holds
PARTITION_TRACE = ("partition_kernel",)
PARTITION_PICK_TRACE = ("pick_kernel",)


class RowPartition:
    """Kernel P's state for the trees of one fit over ``n`` rows and
    ``num_leaves`` leaves (a fit makes one and passes it to each tree).

    Everything is allocated here, once; :meth:`begin_tree` resets it for the
    next tree. One int32 buffer holds ``seg``, ``side``, ``small`` and the
    kernel's per-step counters (left rows, right rows, blocks arrived), so a
    tree's reset is two copies from prepared start states. On the GPU the
    kernel's arguments are packed once and a step sets only ``s`` (and the
    pointers of ``bins``, ``node`` and kernel E's outputs when they change);
    its launches go to the partition's card, into the stream current there
    when the partition was made."""

    def __init__(self, n: int, num_leaves: int, device):
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if not 0 < n < 2 ** 31:
            raise ValueError(f"n={n}: row ids are int32")
        L = int(num_leaves)
        self.n, self.num_leaves, self.device = int(n), L, dev
        self.ids = torch.empty((2, n), dtype=torch.int32, device=dev)
        # seg (L, 2), side (L,), small (3,), the kernel's counters (L - 1, 3),
        # then the mesh entry's counts (2,)
        self._state = torch.empty(3 * L + 3 + 3 * (L - 1) + 2, dtype=torch.int32, device=dev)
        self.seg = self._state[:2 * L].view(L, 2)
        self.side = self._state[2 * L:3 * L]
        self.small = self._state[3 * L:3 * L + 3]
        self.counts = self._state[-2:]
        self.smaller_right = torch.zeros(1, dtype=torch.bool, device=dev)
        start = torch.zeros_like(self._state, device="cpu")
        start[1] = n  # seg[0] = (0, n)
        self._start = start.to(dev)
        self._ids = torch.arange(n, dtype=torch.int32, device=dev)
        self._args = self._bound = None
        if dev.type == "cuda":
            self._args = _PartArgs(
                ids=self.ids.data_ptr(), seg=self.seg.data_ptr(), side=self.side.data_ptr(),
                counters=self._state[3 * L + 3:].data_ptr(), small=self.small.data_ptr(),
                smaller_right=self.smaller_right.data_ptr(), counts=self.counts.data_ptr(),
                n=self.n, device=dev.index)
            self._args_ref = ctypes.byref(self._args)
            self._stream = torch.cuda.current_stream(dev).cuda_stream

    def begin_tree(self) -> None:
        """``ids[0] = 0..n-1``, ``seg[0] = (0, n)`` in buffer 0, every other
        leaf empty, every step's counters 0."""
        self.ids[0].copy_(self._ids)
        self._state.copy_(self._start)

    def rows(self, leaf: int) -> torch.Tensor:
        """Leaf ``leaf``'s row ids: its slice of the buffer ``side`` names
        (reads ``seg`` and ``side`` on the host; for tests and tools)."""
        begin, count = (int(v) for v in self.seg[leaf])
        return self.ids[int(self.side[leaf]), begin:begin + count]

    def split(self, s: int, binned: torch.Tensor, node: torch.Tensor, choice: torch.Tensor,
              ok: torch.Tensor, in_set: torch.Tensor, mesh: bool = False) -> None:
        """Split step ``s`` (kernel E's ``choice`` (2,) int64 leaf and
        feature, ``ok`` (1,) bool, ``in_set`` (B,) bool), updating ``ids``,
        ``seg``, ``side``, ``node`` (n,) int32, ``small`` and
        ``smaller_right``. On the GPU each step number splits once after
        :meth:`begin_tree` (an inert step aside): its counters start at 0.
        ``mesh``: the mesh entry, which writes ``counts`` in place of
        ``small`` and ``smaller_right`` (all-reduce ``counts``, then call
        :meth:`pick`)."""
        if not 0 <= s < self.num_leaves - 1:
            raise ValueError(f"step {s} outside 0..{self.num_leaves - 2}")
        if binned.dim() != 2 or binned.shape[0] != self.n or binned.dtype not in _BIN_DTYPES \
                or binned.device != self.device:
            raise TypeError(f"binned must be ({self.n}, d) int8/int16/int32 on "
                            f"{self.device}, got {binned.dtype} {tuple(binned.shape)} on "
                            f"{binned.device}")
        if self._args is None:
            partition_plain(self, s, binned, node, choice, ok, in_set, mesh)
            return
        bound = (binned.data_ptr(), binned.dtype, binned.shape[1], node.data_ptr(),
                 choice.data_ptr(), ok.data_ptr(), in_set.data_ptr(), in_set.shape[0])
        if bound != self._bound:  # other tensors than the last step's: check, re-point
            for t, dt, shape in ((binned, binned.dtype, binned.shape),
                                 (node, torch.int32, (self.n,)), (choice, torch.int64, (2,)),
                                 (ok, torch.bool, (1,)), (in_set, torch.bool, in_set.shape)):
                if t.dtype != dt or t.shape != shape or t.device != self.device \
                        or not t.is_contiguous() or (t is in_set and t.dim() != 1):
                    raise TypeError(f"expected a contiguous {dt} {tuple(shape)} tensor on "
                                    f"{self.device}, got {t.dtype} {tuple(t.shape)}")
            a = self._args
            a.bins, _, a.d, a.node, a.choice, a.ok, a.in_set, a.n_bins = bound
            self._bound, self._bin_bytes = bound, binned.element_size()
        self._args.s, self._args.mesh = s, int(mesh)
        (PARTITION_MESH_KERNEL if mesh else PARTITION_KERNEL)(
            self._args_ref, self._bin_bytes, self._stream)

    def pick(self, s: int, choice: torch.Tensor, ok: torch.Tensor) -> None:
        """The mesh entry's second half for step ``s`` (the ``choice`` and
        ``ok`` its :meth:`split` took), after ``counts`` was all-reduced:
        ``smaller_right`` = global right rows <= global left rows,
        ``small`` = that child's local (begin, count, buffer); an inert step
        records an empty child on the right."""
        if self._args is None:
            pick_plain(self, s, choice, ok)
            return
        if (choice.data_ptr(), ok.data_ptr()) != (self._args.choice, self._args.ok):
            raise ValueError("pick takes the choice and ok of the step's split")
        self._args.s = s
        PARTITION_PICK_KERNEL(self._args_ref, self._stream)


def partition_plain(part: RowPartition, s: int, binned: torch.Tensor, node: torch.Tensor,
                    choice: torch.Tensor, ok: torch.Tensor, in_set: torch.Tensor,
                    mesh: bool = False) -> None:
    """Plain PyTorch version of :meth:`RowPartition.split`: a stable
    boolean-mask partition of the split leaf's slice, written into the same
    range of the other buffer; ``mesh`` writes the counts, not the side."""
    if not bool(ok[0]):
        if mesh:
            part.counts.zero_()
        else:
            part.small.zero_()
            part.smaller_right.fill_(True)
        return
    leaf, feat = int(choice[0]), int(choice[1])
    begin, count = (int(v) for v in part.seg[leaf])
    src = int(part.side[leaf])
    rows = part.ids[src, begin:begin + count]
    col = binned[rows.long(), feat].to(torch.int64)
    B = in_set.shape[0]
    go_left = (col >= 0) & (col < B) & in_set[col.clamp(0, B - 1)]
    n_left = int(go_left.sum())
    n_right = count - n_left
    right = rows[~go_left]
    node[right.long()] = s + 1
    part.ids[1 - src, begin:begin + count] = torch.cat([rows[go_left], right])
    part.seg[leaf, 1] = n_left
    part.seg[s + 1, 0], part.seg[s + 1, 1] = begin + n_left, n_right
    part.side[leaf] = part.side[s + 1] = 1 - src
    if mesh:
        part.counts[0], part.counts[1] = n_left, n_right
        return
    right_smaller = n_right <= n_left
    part.small[0] = begin + n_left if right_smaller else begin
    part.small[1] = n_right if right_smaller else n_left
    part.small[2] = 1 - src
    part.smaller_right.fill_(right_smaller)


def pick_plain(part: RowPartition, s: int, choice: torch.Tensor, ok: torch.Tensor) -> None:
    """Plain PyTorch version of :meth:`RowPartition.pick`."""
    if not bool(ok[0]):
        part.small.zero_()
        part.smaller_right.fill_(True)
        return
    right_smaller = int(part.counts[1]) <= int(part.counts[0])
    c = s + 1 if right_smaller else int(choice[0])
    part.small[0], part.small[1] = part.seg[c, 0], part.seg[c, 1]
    part.small[2] = part.side[c]
    part.smaller_right.fill_(right_smaller)
