"""The port's entry points compute in float32 whatever the process's TF32
flags say, and give the caller's flags back.

torch turns TF32 on for cuDNN convolutions by default. A forward hook on
the encoder records the flags it runs under, through
``StreamingServer.step``, ``InferencePipeline.run_video`` and a
``PHNet.forward`` that raises; the flags are read again afterwards. On the
CPU no TF32 exists, but the flags are process state all the same."""

import pytest
import torch

import phnet_torch.config as tcfg
from phnet_torch.models import PHNet
from phnet_torch.pipeline import InferencePipeline
from phnet_torch.serving import StreamingServer

import torch_parity as tp


def tf32_flags():
    return (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


def other_cudnn_flags():
    c = torch.backends.cudnn
    return c.enabled, c.benchmark, c.deterministic


@pytest.fixture
def caller_flags():
    """Both TF32 flags on and cuDNN's others away from torch's defaults,
    as a caller might leave them; the process's own flags come back
    after the test."""
    c = torch.backends.cudnn
    saved = (torch.get_float32_matmul_precision(), c.allow_tf32, c.enabled,
             c.benchmark, c.deterministic)
    c.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    c.benchmark, c.deterministic = True, True
    try:
        yield other_cudnn_flags()
    finally:
        torch.set_float32_matmul_precision(saved[0])
        c.allow_tf32, c.enabled, c.benchmark, c.deterministic = saved[1:]


def state_dict(cfg):
    model = PHNet(cfg, device="cpu")
    model.reset_parameters(torch.Generator().manual_seed(0))
    return model.state_dict()


def record_encoder_flags(model, seen):
    """The flags the encoder and the DynamicConv weight collapse (run
    when weights are loaded) compute under."""
    model.encoder.register_forward_hook(lambda *_: seen.append(tf32_flags()))
    for dyn in model.head.dyn_heads:
        combine = dyn.combine_weights
        dyn.combine_weights = lambda f=combine: (seen.append(tf32_flags()),
                                                 f())[1]


def run_server(cfg, seen):
    weights = state_dict(cfg)
    server = StreamingServer(tcfg.Config(model=cfg), weights,
                             max_streams=2, memory_window=4, device="cpu")
    record_encoder_flags(server.model, seen)
    server.update_variables(weights)
    sids = [server.attach(), server.attach()]
    for seed in (1, 2):
        server.step({s: tp.seeded_frames(seed + 10 * s, (64, 128, 3))
                     for s in sids})


def run_pipeline(cfg, seen):
    weights = state_dict(cfg)
    pipe = InferencePipeline(tcfg.Config(model=cfg), weights, chunk=2,
                             device="cpu")
    record_encoder_flags(pipe.model, seen)
    pipe.update_variables(weights)
    pipe.run_video(tp.seeded_frames(3, (3, 64, 128, 3)))


def run_raising_forward(cfg, seen):
    """A forward whose head fails after the encoder ran: the flags still
    come back."""
    model = PHNet(cfg, device="cpu")
    model.load_state_dict(state_dict(cfg))
    record_encoder_flags(model, seen)

    def fail(*_):
        raise RuntimeError("head failed")

    model.head.register_forward_pre_hook(fail)
    with pytest.raises(RuntimeError, match="head failed"):
        model(torch.from_numpy(tp.seeded_frames(4, (1, 2, 64, 128, 3))))


@pytest.mark.parametrize("entry", [run_server, run_pipeline,
                                   run_raising_forward])
def test_entry_points_run_f32_and_restore_flags(caller_flags, entry):
    seen = []
    entry(tp.torch_cfg(), seen)
    assert seen and all(flags == (False, False) for flags in seen)
    assert tf32_flags() == (True, True)
    assert other_cudnn_flags() == caller_flags


def test_caller_matmul_precision_kept():
    """A caller's ``"medium"`` matmul precision (bf16 allowed) comes back
    as it was, not as plain TF32."""
    cfg = tp.torch_cfg()
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")
    try:
        seen = []
        run_server(cfg, seen)
        assert seen and all(flags[1] is False for flags in seen)
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision(saved)
