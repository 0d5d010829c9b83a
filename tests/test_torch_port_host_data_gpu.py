"""The flat state and the host data mode on the card (``gpu`` marker): the
twins of the bit-for-bit checks of ``tests/test_torch_port_flat_state.py``
(the flat update against torch's SGD) and
``tests/test_torch_port_host_data.py`` (a host-mode fit against a
device-mode one), where the update and the steps run CUDA kernels inside
captured graphs and the host mode stages from pinned memory on a stream of
its own.

Each test skips inside its fixture where ``torch.cuda.is_available()`` is
false.  The file imports no JAX; where JAX is not installed, skip
``tests/conftest.py``:

    python -m pytest --noconftest -m gpu tests/test_torch_port_host_data_gpu.py
"""

import pytest
import torch

from distributed_training_comparison_tpu_torch._device import pin_card_math
from distributed_training_comparison_tpu_torch.config import load_config
from distributed_training_comparison_tpu_torch.data import synthetic_dataset
from distributed_training_comparison_tpu_torch.models import ViT, get_model
from distributed_training_comparison_tpu_torch.train import (
    DeviceSGD,
    Trainer,
    configure_optimizers,
    forward_backward,
    lr_table,
)

FIT = ["--synthetic-data", "--limit-examples", "580", "--batch-size", "128", "--epoch", "2",
       "--lr-decay-step-size", "1"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (pinned staging and CUDA graphs run only on the card)")
    pin_card_math()
    return torch.device("cuda")


class HP:
    lr = 0.05
    weight_decay = 1e-4
    lr_decay_step_size = 1
    lr_decay_gamma = 0.1


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["resnet", "vit_tiny"])
def test_the_flat_update_against_torch_sgd_on_the_card(cuda_device, kind):
    """Three steps of ``DeviceSGD`` over flat buffers against torch's SGD on
    copies of one model, the same gradients given to all: torch's
    single-tensor SGD (``foreach=False``) and its default on the card (the
    ``_foreach_*`` kernels).  On the CPU the flat update is torch's bit for
    bit; on the card torch's kernels round some of the same ops apart (the
    last, ``addcmul`` by the device LR against ``add_(alpha=-lr)``, read an
    ulp apart), so each parameter and momentum buffer is held within 2^-19
    of the tensor's largest magnitude (16 fp32 ulps: an ulp an op, four ops
    a step, three steps)."""
    def build():
        model = (ViT(depth=2, dim=192, heads=3, image_size=32) if kind == "vit_tiny"
                 else get_model("resnet18"))
        model.init_weights(torch.Generator().manual_seed(7))
        return model.to(cuda_device)

    ref = build()
    copies = {"single": build(), "foreach": build(), "flat": build()}
    for m in copies.values():
        m.load_state_dict(ref.state_dict())
    opts = {name: configure_optimizers(HP, 2, copies[name].parameters())[0]
            for name in ("single", "foreach", "flat")}
    for name, foreach in (("single", False), ("foreach", True)):
        opts[name].param_groups[0]["foreach"] = foreach
    _, schedule = configure_optimizers(HP, 2, ref.parameters())
    sgd = DeviceSGD(opts["flat"], lr_table(schedule, 6, cuda_device))
    size = 16 if kind == "resnet" else 32
    for step in range(3):
        images, labels = synthetic_dataset(32, image_shape=(size, size, 3), seed=step)
        forward_backward(ref, torch.from_numpy(images).to(cuda_device),
                         torch.from_numpy(labels).long().to(cuda_device))
        for m in copies.values():
            for p, q in zip(ref.parameters(), m.parameters()):
                q.grad = p.grad.clone()
        for name in ("single", "foreach"):
            for group in opts[name].param_groups:
                group["lr"] = schedule(step)
            opts[name].step()
        sgd.step(torch.tensor(True, device=cuda_device))
        named = {name: list(m.named_parameters()) for name, m in copies.items()}
        for i, (pname, q) in enumerate(named["flat"]):
            bq = opts["flat"].state[q]["momentum_buffer"]
            for ref_name in ("single", "foreach"):
                p = named[ref_name][i][1]
                bp = opts[ref_name].state[p]["momentum_buffer"]
                for got, want in ((q, p), (bq, bp)):
                    err = (got - want).abs().max().item()
                    assert err <= 2**-19 * want.abs().max().item(), (step, pname, ref_name, err)


def _state(trainer) -> dict:
    out = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    for name, p in trainer.model.named_parameters():
        out[f"momentum:{name}"] = trainer.optimizer.state[p]["momentum_buffer"].clone()
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("chunk,prefetch,workers", [(3, 2, 2), (2, 1, 0), (4, 0, 2)])
def test_a_host_mode_fit_ends_where_the_device_mode_fit_ends_on_the_card(
        cuda_device, tmp_path, chunk, prefetch, workers):
    """bf16 ResNet-18, 522 training images in 4 steps of 128, two epochs,
    through the captured step: ``--data-mode host`` (pinned chunks copied
    on the ring's stream) ends bit for bit where ``--data-mode device``
    ends, epoch records and state, and the ring's host buffers are
    pinned."""
    runs = {}
    for mode in ("device", "host"):
        extra = (["--data-mode", "host", "--host-chunk-steps", str(chunk), "--device-prefetch",
                  str(prefetch), "--workers", str(workers)] if mode == "host" else [])
        trainer = Trainer(load_config(["--amp", *FIT, *extra, "--ckpt-path",
                                       str(tmp_path / mode)]))
        fit = trainer.fit()
        trainer.close()
        assert trainer.runner.program.captured
        runs[mode] = (fit, _state(trainer), trainer)
    (fit_d, state_d, _), (fit_h, state_h, host) = runs["device"], runs["host"]
    assert all(t.is_pinned() for pair in host.runner.ring.pinned for t in pair)
    keys = ("steps", "skipped", "train_loss", "train_acc", "val_loss", "val_acc")
    assert [{k: e[k] for k in keys} for e in fit_h["epochs"]] == [
        {k: e[k] for k in keys} for e in fit_d["epochs"]]
    assert fit_h["applied_steps"] == fit_d["applied_steps"] == 8
    for k, v in state_d.items():
        assert torch.equal(state_h[k], v), k
