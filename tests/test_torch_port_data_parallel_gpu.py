"""The data-parallel backend on the card (``gpu`` marker): ``--backend ddp``
at a world of one process over NCCL, the twin of the CPU tests' gloo
ranks (``tests/test_torch_port_data_parallel_ranks.py``).

The step program carries the NCCL all-reduce of the flat gradients inside
its captured step (captured in ``thread_local`` mode); at one process the
average leaves the numbers alone, so the run is the ``single`` backend's
bit for bit.  Asking for more cards than the machine has raises.

Each test skips inside its fixture where ``torch.cuda.is_available()`` is
false.  The file imports no JAX; where JAX is not installed, skip
``tests/conftest.py``:

    python -m pytest --noconftest -m gpu tests/test_torch_port_data_parallel_gpu.py
"""

import socket

import pytest
import torch

from distributed_training_comparison_tpu_torch import entry
from distributed_training_comparison_tpu_torch._device import pin_card_math
from distributed_training_comparison_tpu_torch.config import load_config
from distributed_training_comparison_tpu_torch.parallel import dist as pdist
from distributed_training_comparison_tpu_torch.train import Trainer

RESNET = ["--model", "resnet18", "--amp", "--synthetic-data", "--limit-examples", "440",
          "--batch-size", "128", "--epoch", "1", "--lr-decay-step-size", "1"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture
def ddp_flags():
    """``--backend ddp`` on one card, the group's rendezvous on a port the
    OS picked; the group is left at the end."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (NCCL and CUDA graphs run only on the card)")
    pin_card_math()
    yield ["--backend", "ddp", "--num-devices", "1", "--dist-url", f"127.0.0.1:{_free_port()}"]
    pdist.destroy()


def _steps(trainer, n: int) -> list[float]:
    trainer.runner.start_epoch(0)
    for _ in range(n):
        trainer.runner.step()
    torch.cuda.synchronize()
    return trainer.runner.metrics[:n, 0].tolist()


def _nccl_kernels(fn) -> dict[str, int]:
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names: dict[str, int] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and (
                "nccl" in e.name.lower() or "onerank" in e.name.lower()):
            names[e.name] = names.get(e.name, 0) + 1
    return names


@pytest.mark.gpu
def test_ddp_on_one_card_replays_the_single_backend_bit_for_bit(ddp_flags, tmp_path):
    """bf16 ResNet-18, three replayed steps under ``--backend ddp`` (one
    process, NCCL) and ``single`` from one seed: the same losses and
    state, bit for bit; a replayed ddp step launches an NCCL kernel for
    its flat gradient buffer."""
    single = Trainer(load_config([*RESNET, "--ckpt-path", str(tmp_path / "single")]))
    ddp = Trainer(load_config([*RESNET, *ddp_flags, "--ckpt-path", str(tmp_path / "ddp")]))
    assert ddp.group is not None and ddp.world == 1 and single.group is None
    assert _steps(ddp, 3) == _steps(single, 3)
    assert ddp.runner.program.captured
    for (name, a), b in zip(ddp.model.state_dict().items(), single.model.state_dict().values()):
        assert torch.equal(a, b), name
    nccl = _nccl_kernels(ddp.runner.step)
    assert sum(nccl.values()) == len(ddp.sgd.grads.flats), nccl
    ddp.close()
    single.close()


@pytest.mark.gpu
def test_more_cards_than_the_machine_has_raise(ddp_flags, tmp_path):
    """``--num-devices`` past the visible cards raises before any process
    or group starts; nothing falls back to fewer cards or to the CPU."""
    have = torch.cuda.device_count()
    argv = [*RESNET, *ddp_flags[:2], "--num-devices", str(have + 1),
            "--ckpt-path", str(tmp_path)]
    with pytest.raises(ValueError, match=f"requested {have + 1} cards, have {have}"):
        entry.run(argv)
    assert not torch.distributed.is_initialized()
