"""Flat state buffers: the step's tensors as views into one flat buffer per
dtype.

The JAX package updates the whole train state in one fused program; the
port's step does the same work over a few contiguous buffers.  Each kind of
state (the parameters, their momentum buffers, BatchNorm's running
statistics) is held in one flat buffer per dtype, and every tensor of that
kind becomes a view into it (:func:`flatten_`).  The tensors stay the same
objects (``set_`` moves their data, never the object: an ``nn.Parameter``
is still the module's and the optimizer's), so a restore ``copy_``s into
them and a CUDA graph captured on their addresses stays valid.

A :class:`FlatLayout` places each tensor at an offset aligned to
``ALIGN_BYTES`` with its own shape and strides: a ``channels_last``
convolution weight stays ``channels_last``, and a contiguous weight that a
CUDA kernel reads by pointer stays contiguous and aligned.  The padding
between tensors is zero and stays zero.

Flatten once the model has its final device and memory format, and before
the first warm-up or capture.
"""

from __future__ import annotations

from typing import Sequence

import torch

ALIGN_BYTES = 256

# (group, offset, shape, stride) of one tensor in its dtype's flat buffer
Slot = tuple[int, int, tuple[int, ...], tuple[int, ...]]


def _contiguous_strides(shape: Sequence[int]) -> tuple[int, ...]:
    strides, n = [], 1
    for size in reversed(shape):
        strides.append(n)
        n *= max(size, 1)
    return tuple(reversed(strides))


def _dense_strides(t: torch.Tensor) -> tuple[int, ...]:
    """``t``'s strides where its memory is dense (contiguous, or
    ``channels_last`` for a 4-d tensor), else the contiguous ones."""
    if t.is_contiguous() or (t.dim() == 4 and t.is_contiguous(memory_format=torch.channels_last)):
        return tuple(t.stride())
    return _contiguous_strides(t.shape)


class FlatLayout:
    """Where each of ``tensors`` lies in its dtype's flat buffer: groups by
    dtype in the order of first appearance, offsets in the order given."""

    def __init__(self, tensors: Sequence[torch.Tensor]) -> None:
        self.dtypes: list[torch.dtype] = []
        self.sizes: list[int] = []
        self.slots: list[Slot] = []
        for t in tensors:
            if t.dtype not in self.dtypes:
                self.dtypes.append(t.dtype)
                self.sizes.append(0)
            g = self.dtypes.index(t.dtype)
            align = max(1, ALIGN_BYTES // t.element_size())
            self.slots.append((g, self.sizes[g], tuple(t.shape), _dense_strides(t)))
            self.sizes[g] += -(-t.numel() // align) * align

    def buffers(self, device) -> list[torch.Tensor]:
        """New zero flat buffers, one per dtype."""
        return [torch.zeros(n, dtype=d, device=device) for d, n in zip(self.dtypes, self.sizes)]

    def views(self, flats: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        """Each tensor's view into ``flats`` (buffers of this layout)."""
        return [flats[g].as_strided(shape, stride, off) for g, off, shape, stride in self.slots]

    def runs(self, present: Sequence[bool]) -> list[tuple[int, int, int]]:
        """``(group, start, end)`` ranges of the flat buffers that cover the
        tensors marked ``present`` and no other: adjacent present tensors
        (with the padding between them) make one range, so with every
        tensor present there is one range a group, the whole buffer."""
        out: list[tuple[int, int, int]] = []
        for g, size in enumerate(self.sizes):
            start = None
            for (group, off, _, _), keep in zip(self.slots, present):
                if group != g:
                    continue
                if keep and start is None:
                    start = off
                elif not keep and start is not None:
                    out.append((g, start, off))
                    start = None
            if start is not None:
                out.append((g, start, size))
        return out


def flat_buffers(tensors: Sequence[torch.Tensor], layout: FlatLayout | None = None):
    """The flat buffers ``tensors`` already lie in, as ``layout`` (by
    default ``FlatLayout(tensors)``) places them, or None where they do
    not: each group's tensors share one storage of the group's size, each
    at its offset with its strides."""
    tensors = list(tensors)
    layout = FlatLayout(tensors) if layout is None else layout
    if not tensors:
        return []
    storages: dict[int, torch.UntypedStorage] = {}
    for t, (g, off, shape, stride) in zip(tensors, layout.slots):
        s = t.untyped_storage()
        if (t.storage_offset() != off or tuple(t.shape) != shape or tuple(t.stride()) != stride
                or s.nbytes() != layout.sizes[g] * t.element_size()):
            return None
        if storages.setdefault(g, s).data_ptr() != s.data_ptr():
            return None
    device = tensors[0].device
    return [torch.empty(0, dtype=d, device=device).set_(storages[g], 0, (n,), (1,))
            for g, (d, n) in enumerate(zip(layout.dtypes, layout.sizes))]


@torch.no_grad()
def flatten_(tensors: Sequence[torch.Tensor],
             layout: FlatLayout | None = None) -> list[torch.Tensor]:
    """Hold ``tensors`` as views into new flat buffers of ``layout`` (by
    default ``FlatLayout(tensors)``; another list's layout puts them in
    step with that list), their values copied, each tensor object kept.
    Tensors that already lie so stay where they are.  Returns the flat
    buffers, one per dtype."""
    tensors = list(tensors)
    layout = FlatLayout(tensors) if layout is None else layout
    if len(layout.slots) != len(tensors):
        raise ValueError(f"a layout of {len(layout.slots)} tensors for {len(tensors)}")
    flats = flat_buffers(tensors, layout)
    if flats is not None:
        return flats
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"flat buffers over tensors on {sorted(map(str, devices))}")
    flats = layout.buffers(devices.pop())
    for t, v in zip(tensors, layout.views(flats)):
        if t.dtype != v.dtype or t.shape != v.shape:
            raise ValueError(f"a {t.dtype} {tuple(t.shape)} tensor in a {v.dtype} "
                             f"{tuple(v.shape)} slot")
        v.copy_(t)
        t.set_(v.untyped_storage(), v.storage_offset(), v.shape, v.stride())
    return flats


class FlatGrads:
    """The gradients of ``params`` gathered into one static flat buffer per
    dtype, in ``layout`` (by default ``FlatLayout(params)``): one
    ``_foreach_copy_`` of every ``.grad`` into its view.  The set of
    parameters that have a gradient is taken at the first gather and held:
    the regions of the others stay zero, and a later gather that finds
    another set raises (a captured step replays the first set)."""

    def __init__(self, params: Sequence[torch.Tensor], layout: FlatLayout | None = None) -> None:
        self.params = list(params)
        self.layout = FlatLayout(self.params) if layout is None else layout
        device = self.params[0].device if self.params else torch.device("cpu")
        self.flats = self.layout.buffers(device)
        self._views = self.layout.views(self.flats)
        self.present: tuple[bool, ...] | None = None

    def gather(self) -> list[torch.Tensor]:
        """Every parameter's ``.grad`` copied into the flat buffers, which
        are returned (the same tensors every call)."""
        present = tuple(p.grad is not None for p in self.params)
        if self.present is None:
            self.present = present
        elif present != self.present:
            changed = [i for i, (a, b) in enumerate(zip(present, self.present)) if a != b]
            raise RuntimeError(f"parameters {changed} gained or lost their gradient after the "
                               "first step: the set of parameters with a gradient is static")
        idx = [i for i, has in enumerate(present) if has]
        if idx:
            torch._foreach_copy_([self._views[i] for i in idx], [self.params[i].grad for i in idx])
        return self.flats

    def scatter(self) -> None:
        """The flat buffers' values copied back into every gathered
        ``.grad`` (for an optimizer that reads ``.grad``, after the
        buffers were reduced in place)."""
        idx = [i for i, has in enumerate(self.present or ()) if has]
        if idx:
            torch._foreach_copy_([self.params[i].grad for i in idx], [self._views[i] for i in idx])
