"""The port's training pieces around the step, at the small configuration
(``torch_parity``): the optimizer and its schedule against the JAX
package's ``build_optimizer``, the decay mask, remat, gradient
accumulation, checkpoints and resume, dropout, the synthetic labels, the
trainer and the command line's errors."""

import copy
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import phnet_torch.config as tcfgmod
import phnet_tpu.config as jcfgmod
import torch_parity as tp
from phnet_torch.convert import _flatten, convert, torch_key
from phnet_torch.data import ClipLoader, SyntheticVideoDataset, collate_clips
from phnet_torch.data.synthetic import synthetic_clip
from phnet_torch.losses.criterion import LaneCriterion
from phnet_torch.models.transformer import dropout
from phnet_torch.train import __main__ as cli
from phnet_torch.train.checkpoint import CheckpointManager
from phnet_torch.train.optimizer import (Optimizer, cosine_schedule,
                                         decay_mask, revcol_layer_scales)
from phnet_torch.train.state import create_train_state
from phnet_torch.train.step import make_train_step
from phnet_torch.train.trainer import train
from phnet_tpu.geometry import encode_lane_label as jax_encode
from phnet_tpu.train.optimizer import build_optimizer as jax_optimizer
from phnet_tpu.train.optimizer import cosine_schedule as jax_cosine
from phnet_tpu.train.optimizer import decay_mask as jax_decay_mask
from phnet_tpu.train.optimizer import \
    revcol_layer_scales as jax_revcol_layer_scales

STEPS, TOTAL = 10, 12


def small_cfg(**head):
    m = tp.torch_cfg()
    m = dataclasses.replace(m, head=dataclasses.replace(m.head, **head))
    return tcfgmod.Config(model=m)


def synthetic_batch(m, b=1, t=2, seed=0):
    ds = SyntheticVideoDataset(n_videos=b, frames_per_video=t, img_h=m.img_h,
                               img_w=m.img_w, spec=m.lane,
                               max_lanes=m.max_lanes, seed=seed)
    batch = collate_clips([ds[i] for i in range(b)])
    return (torch.from_numpy(batch["frames"]),
            torch.from_numpy(batch["labels"]))


@pytest.mark.parametrize("solver,backbone", [
    ("adamw", "resnet"), ("sgd", "resnet"), ("adamw", "revcol"),
    ("sgd", "revcol")], ids=["adamw", "sgd", "adamw-revcol", "sgd-revcol"])
def test_optimizer_trajectory_matches_jax(solver, backbone):
    """10 updates of the small model's parameters, the same seeded
    gradients on both sides (one leaf all zeros: decay alone moves it),
    against ``build_optimizer`` (the fused AdamW, or Nesterov SGD). With
    the RevCol backbone (``torch_parity.BACKBONES``), each package's
    ``revcol_layer_scales`` go in as ``lr_scales``: per-group rates
    against the JAX package's scaled updates, momentum and moments
    included. Within 1e-6 plus 2e-6 relative: float32 updates of ~lr, a
    float32 ulp or two of the larger parameters."""
    tcfg = tcfgmod.TrainConfig(solver=solver)
    jtcfg = jcfgmod.TrainConfig(solver=solver)
    if backbone == "revcol":
        jc = tp.small_backbone_cfg(jcfgmod, "revcol")
        tc = tp.small_backbone_cfg(tcfgmod, "revcol")
    else:
        jc, tc = tp.jax_cfg(), tp.torch_cfg()
    variables = tp.init_variables(jc, seed=0)
    model = tp.torch_model(tc, variables)
    scales = jscales = None
    if backbone == "revcol":
        b = tc.backbone
        names = [n for n, _ in model.named_parameters()]
        scales = revcol_layer_scales(names, b.revcol_layers,
                                     b.revcol_num_subnet)
        jscales = jax_revcol_layer_scales(
            variables["params"], b.revcol_layers, b.revcol_num_subnet)
        assert min(scales) < 0.5 and max(scales) == 1.0
    opt = Optimizer(tcfg, TOTAL, model.parameters(), scales)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    tx = jax_optimizer(jtcfg, TOTAL, lr_scales=jscales)
    state = tx.init(params)
    rng = np.random.default_rng(3)
    for step in range(STEPS):
        leaves, tree = jax.tree_util.tree_flatten(jax.tree_util.tree_map(
            lambda p: rng.normal(size=p.shape).astype(np.float32), params))
        first = next(i for i, x in enumerate(leaves) if x.ndim > 1)
        leaves[first] = np.zeros_like(leaves[first])
        gtree = jax.tree_util.tree_unflatten(tree, leaves)
        grads = convert({"params": gtree})
        for name, p in model.named_parameters():
            p.grad = grads[name].clone()
        jgrads = jax.tree_util.tree_map(jnp.asarray, gtree)
        upd, state = tx.update(jgrads, state, params)
        params = jax.tree_util.tree_map(lambda a, u: a + u, params, upd)
        opt.step()
        ref = convert({"params": jax.tree_util.tree_map(np.asarray,
                                                        params)})
        for name, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(),
                                       rtol=2e-6, atol=1e-6,
                                       err_msg=f"{solver} step {step} {name}")
    assert opt.count == STEPS


def test_optimizer_state_without_scales_resumes():
    """An optimizer state of the two-group layout that holds nothing of
    the scales (written before they existed: the bare torch AdamW of that
    layout, no clip) loads, and the resumed updates equal those of an
    optimizer that ran throughout, scaled by 1 or not."""
    tcfg = tcfgmod.TrainConfig(weight_decay=0.1, grad_clip_norm=0.0)
    g = torch.Generator().manual_seed(0)
    base = [torch.randn(4, 3, generator=g), torch.randn(3, generator=g)]
    grads = [[torch.randn(p.shape, generator=g) for p in base]
             for _ in range(3)]

    def params():
        return [torch.nn.Parameter(p.clone()) for p in base]

    def step(opt, ps, gs):
        for p, gr in zip(ps, gs):
            p.grad = gr.clone()
        opt.step()

    old = params()  # the torch optimizer of the two-group layout, bare
    torch_opt = torch.optim.AdamW(
        [{"params": [old[0]]}, {"params": [old[1]], "weight_decay": 0.0}],
        lr=tcfg.learning_rate, betas=tuple(tcfg.momentum), eps=1e-8,
        weight_decay=tcfg.weight_decay)
    for p, gr in zip(old, grads[0]):
        p.grad = gr.clone()
    torch_opt.step()
    saved = {"count": 1, "torch": torch_opt.state_dict()}
    assert all("lr_scale" not in grp for grp in saved["torch"][
        "param_groups"])
    ref = params()
    ref_opt = Optimizer(tcfg, 10, ref)
    for gs in grads:
        step(ref_opt, ref, gs)
    for scales in (None, [1.0, 1.0]):
        ps = [torch.nn.Parameter(p.detach().clone()) for p in old]
        opt = Optimizer(tcfg, 10, ps, scales)
        opt.load_state_dict(copy.deepcopy(saved))  # as read from disk
        for gs in grads[1:]:
            step(opt, ps, gs)
        for p, r in zip(ps, ref):
            torch.testing.assert_close(p, r, rtol=0, atol=0)


def test_cosine_schedule_matches_jax():
    ours, ref = cosine_schedule(5e-4, TOTAL), jax_cosine(5e-4, TOTAL)
    for step in range(TOTAL + 3):
        assert ours(step) == pytest.approx(float(ref(step)), rel=1e-6,
                                           abs=1e-12)
    assert ours(0) == pytest.approx(5e-4)  # the first update uses lr(0)
    assert ours(TOTAL) == 0.0


def test_first_update_uses_lr0():
    """AdamW's first step moves every entry with a nonzero gradient by
    lr(0) (m_hat / sqrt(v_hat) = +-1), plus the decay."""
    p = torch.nn.Parameter(torch.ones(3, 4))
    opt = Optimizer(tcfgmod.TrainConfig(weight_decay=0.0), 100, [p])
    p.grad = torch.full((3, 4), -2.0)
    opt.step()
    np.testing.assert_allclose(p.detach().numpy(), 1.0 + 5e-4, rtol=1e-6)


def test_decay_mask_matches_jax():
    variables = tp.init_variables(tp.jax_cfg(), seed=0)
    model = tp.torch_model(tp.torch_cfg(), variables)
    names = [n for n, _ in model.named_parameters()]
    ours = dict(zip(names, decay_mask(p for _, p in model.named_parameters())))
    mask = jax_decay_mask(variables["params"])
    ref = {}
    for path, leaf in _flatten({"params": variables["params"]}):
        node = mask
        for key in path[1:]:
            node = node[key]
        ref[torch_key(path, leaf.ndim)[0]] = bool(node)
    assert ours == ref
    assert ours["head.routers.0.ln_params"] and not ours[
        "encoder.backbone.bn0.weight"]


def step_once(cfg, frames, labels, seed=5, accum=1, state=None):
    state = state or create_train_state(cfg, 100, "cpu", seed=1)
    crit = LaneCriterion(cfg.model, cfg.train.loss)
    return make_train_step(crit, accum)(state, frames, labels, seed)


def test_remat_equals_no_remat_with_dropout():
    """Dropout 0.1 from the step's seed: the recomputed frames draw the
    same masks, so loss and every gradient are bit-equal."""
    cfg = small_cfg(decoder_dropout=0.1)
    frames, labels = synthetic_batch(cfg.model, t=3)
    results = []
    for remat in (True, False):
        c = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, remat_frames=remat))
        state = create_train_state(c, 100, "cpu", seed=1)
        model = state.model
        outs, _ = model.train_forward(frames, labels, dropout_seed=11)
        loss, _ = LaneCriterion(c.model, c.train.loss)(outs, labels)
        loss.backward()
        results.append((loss.item(), [p.grad.clone() for p in
                                      model.parameters()]))
    assert results[0][0] == results[1][0]
    for a, b in zip(results[0][1], results[1][1]):
        assert torch.equal(a, b)


def test_accumulation_is_the_mean_of_micro_batches():
    """accum_steps=2 over 2 clips: the loss and the update equal the mean
    of the two clips' losses and gradients taken one by one, and the
    BatchNorm running statistics took both micro-batches in turn. (Not
    equal to one pass over both clips: BatchNorm's batch statistics are
    each micro-batch's, as in the JAX package.)"""
    cfg = small_cfg(decoder_dropout=0.0)
    frames, labels = synthetic_batch(cfg.model, b=2, t=2)
    state, metrics = step_once(cfg, frames, labels, accum=2)
    ref = create_train_state(cfg, 100, "cpu", seed=1)
    crit = LaneCriterion(cfg.model, cfg.train.loss)
    grads, losses = None, []
    for k in range(2):
        outs, _ = ref.model.train_forward(frames[k:k + 1], labels[k:k + 1])
        loss, _ = crit(outs, labels[k:k + 1])
        loss.backward()
        losses.append(loss.item())
    for p in ref.optimizer.params:
        p.grad /= 2
    ref.optimizer.step()
    assert metrics["loss"].item() == pytest.approx(np.mean(losses),
                                                   rel=1e-6)
    got = state.model.state_dict()
    for k, v in ref.model.state_dict().items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0,
                                   atol=1e-6, err_msg=k)


def test_checkpoint_round_trip_resumes_the_same(tmp_path):
    """Save after one step, restore into a fresh state: the next step's
    loss and parameters equal those of the run that went on."""
    cfg = small_cfg(decoder_dropout=0.1)
    frames, labels = synthetic_batch(cfg.model, t=2)
    state, _ = step_once(cfg, frames, labels, seed=1)
    state.min_loss = 3.5
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(state, epoch=4, max_skip=15, is_best=True)
    assert ckpt.latest_epoch() == 4
    fresh = create_train_state(cfg, 100, "cpu", seed=9)
    fresh, epoch, max_skip = ckpt.restore_state(fresh)
    assert (epoch, max_skip, fresh.step, fresh.min_loss) == (4, 15, 1, 3.5)
    assert fresh.optimizer.count == 1
    a, ma = step_once(cfg, frames, labels, seed=2, state=state)
    b, mb = step_once(cfg, frames, labels, seed=2, state=fresh)
    assert ma["loss"].item() == mb["loss"].item()
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    weights = ckpt.restore_weights(create_train_state(cfg, 100, "cpu",
                                                      seed=9), "best")
    assert weights.step == 0
    assert all(torch.equal(weights.model.state_dict()[k], v) for k, v in
               CheckpointManager(str(tmp_path)).restore("best")[
                   "params"].items())


def test_dropout_rate_and_eval_determinism():
    g = torch.Generator().manual_seed(0)
    x = torch.ones(200_000)
    y = dropout(x, 0.1, g)
    assert abs((y == 0).float().mean().item() - 0.1) < 0.005
    assert torch.allclose(y[y != 0], torch.tensor(1 / 0.9))
    assert dropout(x, 0.1, None) is x
    cfg = small_cfg()  # decoder_dropout 0.1, the VIL default
    assert cfg.model.head.decoder_dropout == 0.1
    state = create_train_state(cfg, 100, "cpu", seed=1)
    model = state.model
    frames, labels = synthetic_batch(cfg.model, t=2)
    with torch.no_grad():
        a = model.train_forward(frames, labels, dropout_seed=3)[0]
        b = model.train_forward(frames, labels, dropout_seed=3)[0]
        c = model.train_forward(frames, labels, dropout_seed=4)[0]
        model.eval()
        e1, e2 = model(frames)[0], model(frames)[0]
    assert torch.equal(a.pred_sec, b.pred_sec)
    assert not torch.equal(a.pred_sec, c.pred_sec)
    # stage 0's first branch sees no decoder (later stages do, through
    # the blended priors)
    assert torch.equal(a.pred_fir[:, 0], c.pred_fir[:, 0])
    assert torch.equal(e1.kept, e2.kept)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_synthetic_labels_equal_jax_encoder(seed):
    """The port's synthetic clip: its labels equal the JAX package's
    ``encode_lane_label`` on the same lane points, at full width."""
    spec = tcfgmod.LaneSpec()
    clip = synthetic_clip(seed, 3, spec=spec)
    assert clip["frames"].shape == (3, 384, 768, 3)
    assert np.isfinite(clip["frames"]).all()
    for t in range(3):
        lanes = [list(map(tuple, p)) for p in clip["points"][t]]
        ref = jax_encode(lanes, list(range(len(lanes))),
                         jcfgmod.LaneSpec(), 384, 768, 8)
        np.testing.assert_array_equal(clip["labels"][t], ref)
        assert (clip["labels"][t][:, 1] == 1.0).sum() >= 1


def test_synthetic_labels_equal_jax_synthetic_clip():
    cv2 = pytest.importorskip("cv2")
    del cv2
    from phnet_tpu.data.synthetic import synthetic_clip as jax_clip

    ours, ref = synthetic_clip(7, 2), jax_clip(7, 2)
    np.testing.assert_array_equal(ours["labels"], ref["labels"])


def test_trainer_trains_and_resumes(tmp_path):
    """train() for one epoch of 2 steps, then resumed to a second epoch:
    finite losses, the log, the checkpoints, and the resumed step, epoch
    and max_skip."""
    cfg = small_cfg()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, epoch_per_test=1, epochs_per_increment=1))
    m = cfg.model

    def data():
        ds = SyntheticVideoDataset(n_videos=2, frames_per_video=2,
                                   img_h=m.img_h, img_w=m.img_w, spec=m.lane,
                                   max_lanes=m.max_lanes)
        return ds, ClipLoader(ds, batch_size=1, seed=0)

    ds, loader = data()
    state, hist = train(cfg, ds, loader, str(tmp_path), epochs=1,
                        device="cpu", verbose=False)
    assert len(hist) == 1 and np.isfinite(hist[0])
    assert state.step == 2 and ds.max_skip == 5
    ds2, loader2 = data()
    state2, hist2 = train(cfg, ds2, loader2, str(tmp_path), epochs=2,
                          resume=True, device="cpu", verbose=False)
    assert len(hist2) == 1 and np.isfinite(hist2[0])
    assert state2.step == 4 and ds2.max_skip == 10
    files = sorted(p.name for p in tmp_path.iterdir())
    assert files == ["best.pt", "epoch_1.pt", "epoch_2.pt", "log.txt"]
    assert (tmp_path / "log.txt").read_text().count("TrainLoss") == 2


@pytest.mark.parametrize("argv,match", [
    (["--data-root", "/data/VIL100"], "no VIL-100 at /data/VIL100/VIL100"),
    (["--data-root", os.path.dirname(os.path.abspath(__file__))],
     "no VIL-100 at .*tests/VIL100; pass the directory holding VIL100/"),
    (["--synthetic", "--devices", "2", "--batch", "3"],
     "a global batch of 3 clips does not split over 2 ranks"),
    (["--synthetic", "--coordinator", "127.0.0.1:1"],
     "--coordinator, --num-processes and --process-id go together"),
])
def test_cli_clear_errors(argv, match):
    with pytest.raises(SystemExit, match=match):
        cli.main(argv)


def test_config_rejects_unported_training_variants():
    assert tcfgmod.ModelConfig(
        train_assigner="dynamic_k").train_assigner == "dynamic_k"
    with pytest.raises(ValueError, match="train_assigner.*'simota'"):
        tcfgmod.ModelConfig(train_assigner="simota")
    with pytest.raises(ValueError, match="solver"):
        tcfgmod.TrainConfig(solver="lamb")
    with pytest.raises(TypeError):
        tcfgmod.TrainConfig(remat_policy="dots")
    cfg = tcfgmod.vil100_config()
    j = jcfgmod.vil100_config()
    for ours, ref in ((cfg.train, j.train), (cfg.train.loss, j.train.loss)):
        for f in dataclasses.fields(ours):
            if f.name != "loss":
                assert getattr(ours, f.name) == getattr(ref, f.name), f.name
    assert cfg.model.head.decoder_dropout == j.model.head.decoder_dropout
    assert cfg.model.remat_frames == j.model.remat_frames


@pytest.mark.parametrize("quantize", ["none", "w8"])
def test_combine_keeps_the_graph_only_in_f32_training(quantize):
    """DynamicConv's collapsed weights carry gradients in train mode (the
    chain rule to the factored parameters runs once a step), in a float32
    and in a bf16 model (the combine runs in float32 and its result is
    cast to bf16, the bf16 products then differentiated through the
    cast), never in eval mode, and never for the inference-only quantized
    forms."""
    from phnet_torch.models.dynamic_conv import DynamicConv

    for dtype in (None, torch.bfloat16):
        dyn = DynamicConv(feat_size=8, hidden_dim=16, quantize=quantize,
                          dtype=dtype)
        dyn.reset_parameters(torch.Generator().manual_seed(0))
        key = "b" if quantize == "w8" else 1
        combined = dyn.combine_weights()
        assert combined["gen1"][key].requires_grad == (quantize == "none")
        if quantize == "none":
            assert combined["gen1"][0].dtype == (dtype or torch.float32)
            out = dyn(torch.randn(1, 4, 16), torch.randn(1, 4, 8, 16),
                      combined)
            assert out.dtype == torch.float32
            out.sum().backward()
            for lin in (dyn.gen1_a, dyn.gen1_b, dyn.out_a, dyn.out_b):
                assert lin.weight.grad is not None
                assert lin.weight.grad.dtype == torch.float32
        dyn.eval()
        assert not dyn.combine_weights()["gen1"][key].requires_grad
