"""A guard against host reads for the port's CPU tests: it fails where
code reads a tensor back to the host, copies one there, copies host data
to a device, or calls an aten op whose CUDA kernel reads a value or a
size back (forward or backward: torch.trace's backward did). Each is a
host sync, or a copy a CUDA graph cannot capture, on the card. Given a
list, the guard records each read there instead of raising."""
import contextlib

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode


class HostReadError(AssertionError):
    pass


_READS = {torch.Tensor.item, torch.Tensor.__bool__, torch.Tensor.__int__,
          torch.Tensor.__float__, torch.Tensor.__index__,
          torch.Tensor.tolist, torch.Tensor.numpy, torch.Tensor.cpu}


def _zero_d_int_index(index):
    parts = index if isinstance(index, tuple) else (index,)
    return any(torch.is_tensor(i) and i.ndim == 0 and not i.is_floating_point()
               for i in parts)


def _found(reads, what):
    if reads is None:
        raise HostReadError(what)
    reads.append(what)


class NoHostReads(TorchFunctionMode):
    """Raises on every call that reads a tensor back to the host, copies
    one there, or copies host data to a device: `item`, truth, int,
    float and index conversions, `tolist`, `numpy`, `cpu`, `torch.tensor`
    or `torch.as_tensor` of host data onto a device, and indexing by a
    0-d integer tensor (which PyTorch reads as a Python int). With a
    `reads` list it appends each to the list instead."""

    def __init__(self, reads=None):
        super().__init__()
        self.reads = reads

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _READS:
            _found(self.reads, f"host read: {func.__name__}")
        elif func in (torch.tensor, torch.as_tensor) and "device" in kwargs \
                and not torch.is_tensor(args[0]):
            _found(self.reads, f"tensor from host data: {func.__name__}")
        elif func is torch.Tensor.__getitem__ and _zero_d_int_index(args[1]):
            _found(self.reads, "indexed by a 0-d tensor")
        return func(*args, **kwargs)


# aten ops whose CUDA kernels read a value or a size back to the host,
# seen where autograd's backward calls them too (trace's backward fills
# with a 0-d tensor through index_fill, whose value it reads)
_SYNCING_OPS = {"aten._local_scalar_dense.default",
                "aten.index_fill.int_Tensor", "aten.index_fill_.int_Tensor",
                "aten.nonzero.default", "aten.masked_select.default"}


class NoSyncingOps(TorchDispatchMode):
    """Raises on every aten op in `_SYNCING_OPS`, forward or backward
    (with a `reads` list, appends it there instead)."""

    def __init__(self, reads=None):
        super().__init__()
        self.reads = reads

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if str(func) in _SYNCING_OPS:
            _found(self.reads, f"syncing op: {func}")
        return func(*args, **(kwargs or {}))


def guarded(reads=None):
    """Both guards at once; with a `reads` list, both record there."""
    stack = contextlib.ExitStack()
    stack.enter_context(NoHostReads(reads))
    stack.enter_context(NoSyncingOps(reads))
    return stack
