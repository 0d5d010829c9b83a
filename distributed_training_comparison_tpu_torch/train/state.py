"""The train state (``distributed_training_comparison_tpu/train/state.py``).

The JAX package carries everything a step changes in one pytree, a
``TrainState``: ``step``, ``params``, BatchNorm's ``batch_stats`` and the
optax chain's ``opt_state``.  The port keeps the same state where its step
program updates it in place: the model's parameters and running
statistics, the momentum buffers in ``optimizer.state[p]["momentum_buffer"]``
and the applied-step count ``DeviceSGD.applied`` (``train/optim.py``).
:class:`TrainState` gathers them into the JAX ``TrainState``'s state dict
(``flax.serialization.to_state_dict`` of ``checkpoint._state_dict`` in the
JAX package), and writes such a dict back:

- ``step``: the applied-step count, int32, as the JAX state keeps it;
- ``params`` and ``batch_stats``: the flax trees (``models/from_jax.py``'s
  ``vit_to_jax`` / ``resnet_to_jax``; a ViT's ``batch_stats`` is empty);
- ``opt_state``: ``add_decayed_weights`` then ``sgd(momentum, nesterov)``
  as ``{"0": {}, "1": {"0": {"trace": <momentum in the params' layout>},
  "1": {"count": <the schedule's count, the step>}}}``.

Only the layout moves, so a round trip is bit for bit.  A restore writes
every tensor back with ``copy_`` into the tensors that exist: the step
program's CUDA graphs (``EpochRunner``, ``EvalRunner``, the serve
engine's buckets) were captured on their addresses, so a restore never
rebinds one.  The learning rate follows from the count through the LR
table at the next step.

:meth:`TrainState.snapshot` is the copy a write-behind save takes: one
device-side copy of every storage the state's tensors lie in (the few flat
buffers of the parameters, momentum and running statistics,
``train/flat.py``, and any tensor outside them) on the current stream, and
an event recorded after it.  The step program updates the live tensors
in place, so the writer must never read them while the next epoch runs;
it waits on the event on a stream of its own before its one device-to-host
copy (:meth:`StateSnapshot.host_tensors`), holding
``utils.graphs.CAPTURE_LOCK`` so that the copy never runs while a step
program's graph is being captured.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from ..models import ResNet, ViT, resnet_from_jax, resnet_to_jax, vit_from_jax, vit_to_jax
from ..utils.graphs import CAPTURE_LOCK
from .optim import DeviceSGD

MOMENTUM = "momentum:"  # the prefix of a momentum buffer's name among the state's tensors


def model_variables(model: torch.nn.Module, named: Mapping) -> dict:
    """``{"params", "batch_stats"}`` in the flax layout of ``model``'s JAX
    counterpart, from ``named``: its ``state_dict`` (or any mapping under
    its names, such as the momentum buffers by parameter name)."""
    if isinstance(model, ViT):
        return {"params": vit_to_jax(named), "batch_stats": {}}
    if isinstance(model, ResNet):
        return resnet_to_jax(named)
    raise TypeError(f"no JAX layout for a {type(model).__name__}")


def model_state_dict(model: torch.nn.Module, variables: Mapping) -> dict[str, torch.Tensor]:
    """``model``'s ``state_dict`` from flax ``{"params", "batch_stats"}``
    (numpy or CPU tensor leaves): the inverse of :func:`model_variables`."""
    if isinstance(model, ViT):
        if variables.get("batch_stats"):
            raise ValueError("a ViT has no batch_stats")
        return vit_from_jax(variables["params"])
    if isinstance(model, ResNet):
        return resnet_from_jax({"params": variables["params"],
                                "batch_stats": variables["batch_stats"]})
    raise TypeError(f"no JAX layout for a {type(model).__name__}")


def jax_state_dict(model: torch.nn.Module, tensors: Mapping[str, torch.Tensor], step: int) -> dict:
    """The JAX ``TrainState``'s state dict from the state's host tensors by
    name (:meth:`TrainState.tensors`' names) and the applied-step count."""
    weights = {k: v for k, v in tensors.items() if not k.startswith(MOMENTUM)}
    momentum = {k[len(MOMENTUM):]: v for k, v in tensors.items() if k.startswith(MOMENTUM)}
    variables = model_variables(model, weights)
    count = np.asarray(step, dtype=np.int32)
    return {
        "batch_stats": variables["batch_stats"],
        "opt_state": {"0": {}, "1": {"0": {"trace": model_variables(model, momentum)["params"]},
                                     "1": {"count": count}}},
        "params": variables["params"],
        "step": count.copy(),
    }


class StateSnapshot:
    """A copy of a :class:`TrainState`'s tensors, flat on the state's
    device, with the event recorded after the copy on a card.  ``slots``
    places each named tensor in ``flat``: ``(offset, shape, stride)``."""

    def __init__(self, model, names, slots, flat, applied, event) -> None:
        self.model, self.names, self.slots = model, names, slots
        self.flat, self.applied, self.event = flat, applied, event
        self._host: tuple[dict[str, torch.Tensor], int] | None = None

    def host_tensors(self) -> tuple[dict[str, torch.Tensor], int]:
        """The tensors by name on the host, views into one host copy in the
        live tensors' layout (a ``channels_last`` weight keeps its strides),
        and the applied-step count, copied once however often asked.  On a
        card: one copy into pinned memory on a stream of the caller's that
        waits on the snapshot's event (the compute stream goes on)."""
        if self._host is None:
            self._host = self._copy_to_host()
        return self._host

    def _copy_to_host(self) -> tuple[dict[str, torch.Tensor], int]:
        flat, applied = self.flat, self.applied
        if self.event is not None:  # on a writer thread, beside the step program's captures
            with CAPTURE_LOCK:
                stream = torch.cuda.Stream(device=flat.device)
                with torch.cuda.stream(stream):
                    stream.wait_event(self.event)
                    flat = torch.empty(self.flat.shape, dtype=self.flat.dtype, pin_memory=True)
                    flat.copy_(self.flat, non_blocking=True)
                    applied = torch.empty((), dtype=self.applied.dtype, pin_memory=True)
                    applied.copy_(self.applied, non_blocking=True)
                stream.synchronize()
        return ({n: flat.as_strided(shape, stride, off)
                 for n, (off, shape, stride) in zip(self.names, self.slots)}, int(applied))

    def state_dict(self) -> dict:
        """The JAX ``TrainState``'s state dict (numpy leaves)."""
        tensors, step = self.host_tensors()
        return jax_state_dict(self.model, tensors, step)

    def variables(self) -> dict:
        """``{"params", "batch_stats"}`` in the flax layout: a best
        checkpoint's contents."""
        tensors, _ = self.host_tensors()
        return model_variables(self.model, {k: v for k, v in tensors.items()
                                            if not k.startswith(MOMENTUM)})


class TrainState:
    """The live state a step changes: ``model``'s parameters and running
    statistics, ``sgd``'s momentum buffers and applied-step count."""

    def __init__(self, model: torch.nn.Module, sgd: DeviceSGD) -> None:
        self.model, self.sgd = model, sgd

    def tensors(self) -> dict[str, torch.Tensor]:
        """Every fp32 tensor of the state by name: the model's
        ``state_dict`` but ``num_batches_tracked`` (which flax has not),
        then each parameter's momentum buffer under ``MOMENTUM`` + its
        name."""
        out = {k: v for k, v in self.model.state_dict().items()
               if not k.endswith("num_batches_tracked")}
        for name, p in self.model.named_parameters():
            out[MOMENTUM + name] = self.sgd.optimizer.state[p]["momentum_buffer"]
        return out

    @torch.no_grad()
    def snapshot(self) -> StateSnapshot:
        """A device-side copy of the state, on the current stream, and on a
        card an event recorded after it (see the module docstring): one
        ``cat`` of the distinct storages the tensors lie in, each whole, and
        each tensor's place in it."""
        tensors = self.tensors()
        pieces: dict[int, tuple[int, torch.Tensor]] = {}  # storage -> (offset in flat, 1-d view)
        total = 0
        slots = []
        for t in tensors.values():
            storage = t.untyped_storage()
            key = storage.data_ptr()
            if key not in pieces:
                whole = torch.empty(0, dtype=t.dtype, device=t.device).set_(
                    storage, 0, (storage.nbytes() // t.element_size(),), (1,))
                pieces[key] = (total, whole)
                total += whole.numel()
            slots.append((pieces[key][0] + t.storage_offset(), tuple(t.shape), tuple(t.stride())))
        flat = torch.cat([whole for _, whole in pieces.values()])
        applied = self.sgd.applied.clone()
        event = None
        if flat.is_cuda:
            event = torch.cuda.Event()
            event.record()
        return StateSnapshot(self.model, list(tensors), slots, flat, applied, event)

    def state_dict(self) -> dict:
        """The JAX ``TrainState``'s state dict of the live state (it waits
        for the device)."""
        return self.snapshot().state_dict()

    def variables(self) -> dict:
        """The live ``{"params", "batch_stats"}`` in the flax layout."""
        return self.snapshot().variables()

    @torch.no_grad()
    def load_variables(self, variables: Mapping) -> None:
        """Parameters and running statistics from flax ``{"params",
        "batch_stats"}``, copied into the model's tensors
        (``load_state_dict`` copies; ``num_batches_tracked`` becomes 0)."""
        self.model.load_state_dict(model_state_dict(self.model, variables))

    @torch.no_grad()
    def load_state_dict(self, state: Mapping) -> None:
        """The whole state from the JAX ``TrainState``'s state dict (numpy
        or CPU tensor leaves), copied into the live tensors."""
        step = int(np.asarray(state["step"]))
        chain = state["opt_state"]["1"]
        count = int(np.asarray(chain["1"]["count"]))
        if count != step:
            raise ValueError(f"the schedule's count {count} is not the step {step}")
        self.load_variables(state)
        momentum = model_state_dict(self.model, {"params": chain["0"]["trace"],
                                                 "batch_stats": state["batch_stats"]})
        for name, p in self.model.named_parameters():
            self.sgd.optimizer.state[p]["momentum_buffer"].copy_(momentum[name])
        self.sgd.applied.fill_(step)
