"""Shared set-up of the port's training-step parity tests
(``test_torch_train_*.py``): one step of each package at a small
configuration of ``torch_parity`` (VIL or one of OpenLane-V's three
heads), in float32 or bfloat16, B = 1 clip of T = 2 frames, decoder
dropout 0.

The JAX side is ``make_train_step``'s loss function (``model.apply(...,
train=True, mutable=["batch_stats"])`` then ``LaneCriterion``),
differentiated once, without remat (the same function, compiled faster);
a bf16 step is compiled without XLA's excess precision (``exact_jit``:
see ``test_torch_bf16.py``), so that it rounds wherever its program
computes in bf16. A JAX step compiles once and then runs on the frames
and their one-ulp copies.

The one-ulp method (bf16). A bf16 step of this small random model is
chaotic: the port's own gradients move by tens of percent of a leaf's
largest entry when each frame element moves by one bf16 ulp, and so do
its float32 gradients (train-mode BatchNorm at initialization: with the
running statistics in its place the move is 5-10x smaller; four frames,
two clips or 4x the pixels shrink it by a quarter at most). So the port
is held to twice its own one-ulp spread: the largest change of a
quantity over three copies of the frames moved by -1, 0 or +1 ulp per
element (:data:`ULP_SEEDS`). Discrete decisions that such noise flips
are pinned to JAX's: the Hungarian matches (:func:`pinned_assignment`)
and the routers' output gates (:func:`pinned_gates`; the ReLU before the
router's sigmoid, which a flip opens or closes for a whole anchor). The
matches are compared on the *robust* slots (valid targets whose match
all four runs of each package agree on). The spread is measured with
the same pins.

The gradients' bounds cannot tell a bf16 step from a float32 one (the
float32 step's gradients are as near JAX's bf16 ones as the port's bf16
step's). The running statistics can: the forward of the first blocks is
not chaotic. :func:`control_step` gives the steps the tests hold up as
controls, which the bounds must reject.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

import phnet_torch.config as tcfgmod
import phnet_torch.models.phnet as torch_phnet
import phnet_torch.models.router as torch_router
import phnet_tpu.config as jcfgmod
import torch_parity as tp
from phnet_torch.convert import convert
from phnet_torch.losses.criterion import LaneCriterion as TorchCriterion
from phnet_tpu.losses import LaneCriterion as JaxCriterion
from phnet_tpu.models import PHNet as JaxPHNet
from test_torch_bf16 import exact_jit, one_ulp

B, T = 1, 2
ULP_SEEDS = (5, 6, 7)


# the small configuration of each preset: "vil"; OpenLane-V's single head
# "ol", multi-scale head "ms" and prior-propagation head "v3"; VIL with
# the other backbones, "revcol", "r50" and "gn" (``tp.BACKBONES``)
SMALL = {"vil": tp.small_model_cfg, "ol": tp.small_ol_cfg,
         "ms": tp.small_ms_cfg, "v3": tp.small_v3_cfg,
         **{name: functools.partial(tp.small_backbone_cfg, backbone=name)
            for name in tp.BACKBONES}}


def configs(preset: str, dtype: str = "float32", chain_f32: bool = False):
    """(JAX ModelConfig, port ModelConfig, JAX LossConfig, port
    LossConfig) of ``preset`` (a key of :data:`SMALL`) in ``dtype``."""
    j, t = SMALL[preset](jcfgmod), SMALL[preset](tcfgmod)
    if preset in ("vil",) + tuple(tp.BACKBONES):
        jl, tl = jcfgmod.LossConfig(), tcfgmod.LossConfig()
    else:
        jl = jcfgmod.openlane_config().train.loss
        tl = tcfgmod.openlane_config().train.loss

    def adjust(c, **kw):
        return dataclasses.replace(c, compute_dtype=dtype, **kw,
                                   head=dataclasses.replace(
                                       c.head, decoder_dropout=0.0,
                                       router_train_chain_f32=chain_f32))

    return adjust(j, remat_frames=False), adjust(t), jl, tl


def clip_labels(rng, spec, img_w: int, max_lanes: int = 4) -> np.ndarray:
    """[B, T, max_lanes, dim] labels: two lanes a frame, pixel xs inside
    the image (VIL's valid and invalid lengths, or OL's one length)."""
    lab = np.full((B, T, max_lanes, spec.dim), -1e5, np.float32)
    lab[..., 0], lab[..., 1] = 1.0, 0.0
    for i in range(2):
        head = (0.0, 1.0, 0.0, 0.3 + 0.3 * i, 0.5, 0.8, 0.0)
        lab[:, :, i, :spec.header_dim] = head[:spec.header_dim]
        lab[:, :, i, spec.col_xs:] = rng.uniform(
            10, img_w - 18, (B, T, spec.n_offsets))
    return lab


# the scale of the BatchNorm that ends each residual branch of the
# Bottleneck ResNet-50 ("r50"), as a factor of the draw's ~1: the small
# zero-gamma practice of ResNet-50 training. With scales near 1, 16 blocks
# of train-mode BatchNorm amplify float32 rounding ~1.3x a block (both
# packages, at any frame size or batch: their float32 gradients land a
# median 1.3e-2 of a leaf's largest entry from the float64 step), and no
# float32 bound of a leaf could be sharp.
R50_BRANCH_SCALE = 0.1


def problem(preset: str, tc, seed: int = 0):
    """(numpy variables, frames, labels) from ``seed``; for "r50" the
    residual branches' last BatchNorm scales times
    :data:`R50_BRANCH_SCALE`."""
    jc = SMALL[preset](jcfgmod)
    rng = np.random.default_rng(seed)
    frames = rng.normal(size=(B, T, tc.img_h, tc.img_w, 3)).astype(
        np.float32)
    labels = clip_labels(rng, tc.lane, tc.img_w)
    variables = tp.init_variables(jc, seed=seed)
    if preset == "r50":
        for name, block in variables["params"]["encoder"][
                "backbone"].items():
            if name.startswith("Bottleneck_"):
                norm = block["Norm_2"]["BatchNorm_0"]
                norm["scale"] = norm["scale"] * R50_BRANCH_SCALE
    return variables, frames, labels


def jax_step(jc, jloss, variables, labels, dtype=np.float32):
    """A function of the frames giving the JAX step's loss, outputs,
    gradients (port names, float64) and updated BatchNorm statistics; the
    weights, frames and labels go in as ``dtype`` (float64 only where
    64-bit types are enabled: ``jax_float64_step.py``)."""
    model = JaxPHNet(jc)
    criterion = JaxCriterion(jc, jloss)

    def loss_fn(params, batch_stats, f, lab):
        (outs, mem), updates = model.apply(
            {"params": params, "batch_stats": batch_stats}, f, lab,
            train=True, rngs={"dropout": jax.random.key(0)},
            mutable=["batch_stats"])
        loss, _ = criterion(outs, lab)
        return loss, (outs, mem, updates)

    jit = exact_jit if jc.compute_dtype == "bfloat16" else jax.jit
    step = jit(jax.value_and_grad(loss_fn, has_aux=True))
    v = jax.tree_util.tree_map(lambda x: jnp.asarray(x, dtype), variables)

    def run(frames):
        (loss, (outs, mem, updates)), grads = step(
            v["params"], v.get("batch_stats", {}), jnp.asarray(frames,
                                                               dtype),
            jnp.asarray(labels, dtype))
        return dict(
            loss=float(loss), outs=outs, mem=mem,
            matches=np.stack([np.asarray(outs.matched_fir),
                              np.asarray(outs.matched_sec)]),
            grads={k: g.numpy().astype(np.float64) for k, g in convert(
                {"params": jax.tree_util.tree_map(np.asarray, grads)}
            ).items()},
            batch_stats={k: x.numpy() for k, x in convert(
                {"batch_stats": jax.tree_util.tree_map(
                    np.asarray, dict(updates).get("batch_stats", {}))}
            ).items()})

    return run


@contextlib.contextmanager
def jax_float64_step(preset: str, out: pathlib.Path):
    """Runs ``jax_float64_step.py`` on ``preset``'s float32 problem in a
    process of its own while the body runs; yields a function that waits
    for it and returns its loss, matches, outputs (by name) and gradient
    leaves, each float64. LLVM's optimizations are off in that process
    (``--xla_backend_optimization_level=0``): the compile is a fifth
    shorter, and the float64 loss moves by 1e-15 relative."""
    env = dict(os.environ, XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                                      + " --xla_backend_optimization_level=0"
                                      ).strip())
    proc = subprocess.Popen(
        [sys.executable, str(pathlib.Path(__file__).with_name(
            "jax_float64_step.py")), preset, str(out)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)

    def result():
        log, _ = proc.communicate(timeout=900)
        assert proc.returncode == 0, log[-4000:]
        with np.load(out) as z:
            return dict(
                loss=float(z["loss"]), matches=z["matches"],
                outs={k[4:]: z[k] for k in z.files if k.startswith("out.")},
                grads={k[5:]: z[k] for k in z.files
                       if k.startswith("grad.")})

    try:
        yield result
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def f32_run(preset: str, out: pathlib.Path):
    """Everything the float32 step tests compare: the JAX step (``ref``),
    the port's (``got``), the port's step in float64 (``got64``) and the
    JAX package's float64 step (``exact``, :func:`jax_float64_step`, run
    in a process of its own meanwhile)."""
    with jax_float64_step(preset, out) as exact:
        jc, tc, jl, tl = configs(preset)
        variables, frames, labels = problem(preset, tc)
        ref = jax_step(jc, jl, variables, labels)(frames)
        got = port_step(tc, tl, variables, frames, labels)
        got64 = port_step(tc, tl, variables, frames, labels,
                          dtype=torch.float64)
        return dict(ref=ref, got=got, got64=got64, exact=exact())


def leaf_tolerance(name: str) -> float:
    """The float32 bound of a gradient leaf, of its largest entry
    (``test_torch_train.py``'s): 3e-2 for the router chain's parameters,
    3e-3 elsewhere."""
    chain = name.endswith(".taps") or name.endswith(".ln_params")
    return 3e-2 if ".routers." in name and chain else 3e-3


def jax_error(run, name):
    """|JAX float32 - JAX float64| of gradient leaf ``name``."""
    return np.abs(run["ref"]["grads"][name]
                  - run["exact"]["grads"][name]).max()


def check_f32_forward(run, atol=1e-3):
    """Matches bit-equal; predictions and router scores within ``atol``;
    the frame count."""
    ref, got = run["ref"], run["got"]
    np.testing.assert_array_equal(got["matches"], ref["matches"])
    for name in ("pred_fir", "pred_sec", "diff"):
        g = getattr(got["outs"], name).detach().numpy()
        r = np.asarray(getattr(ref["outs"], name))
        assert g.shape == r.shape, name
        np.testing.assert_allclose(g, r, rtol=0, atol=atol, err_msg=name)
    assert got["mem"].t == T


def check_f32_leaf(run, name):
    """A gradient leaf within its float32 bound of JAX's, plus JAX's own
    distance from the float64 step."""
    r, g = run["ref"]["grads"][name], run["got"]["grads"][name]
    assert g.shape == r.shape
    bound = (leaf_tolerance(name) * np.abs(r).max() + 1e-5
             + jax_error(run, name))
    assert np.abs(g - r).max() <= bound, (np.abs(g - r).max(), bound)


def check_f32_running_stats(run, atol=1e-5):
    ref, got = run["ref"], run["got"]
    assert ref["batch_stats"]
    for k, x in ref["batch_stats"].items():
        np.testing.assert_allclose(got["batch_stats"][k], x, rtol=0,
                                   atol=atol, err_msg=k)


def check_f64_step(run, out_atol=1e-5):
    """The port's float64 step against JAX's: matches, loss (1e-7
    relative), outputs (``out_atol``)."""
    got, exact = run["got64"], run["exact"]
    np.testing.assert_array_equal(got["matches"], exact["matches"])
    assert abs(got["loss"] - exact["loss"]) <= 1e-7 * abs(exact["loss"])
    for name, x in exact["outs"].items():
        g = getattr(got["outs"], name).detach().numpy()
        np.testing.assert_allclose(g, x, rtol=0, atol=out_atol,
                                   err_msg=name)


def check_f64_leaf(run, name, rel=1e-5):
    """The port's float64 gradient leaf within ``rel`` of the largest
    entry of JAX's float64 one."""
    g, x = run["got64"]["grads"][name], run["exact"]["grads"][name]
    assert g.shape == x.shape
    bound = rel * np.abs(x).max() + 1e-12
    assert np.abs(g - x).max() <= bound, (np.abs(g - x).max(), bound)


def check_f32_loss_against_f64(run):
    got, exact = run["got"], run["exact"]
    assert abs(got["loss"] - exact["loss"]) <= 1e-5 * abs(exact["loss"])


def check_jax_is_the_farther(run):
    """On the leaves where the port is farther from JAX than the float32
    bound, JAX's float32 gradient is at least twice as far from the exact
    one as the port's. Returns how many leaves that is."""
    far = 0
    for name, x in run["exact"]["grads"].items():
        r, g = run["ref"]["grads"][name], run["got"]["grads"][name]
        if np.abs(g - r).max() <= (leaf_tolerance(name) * np.abs(r).max()
                                   + 1e-5):
            continue
        far += 1
        assert np.abs(g - x).max() * 2 < jax_error(run, name), name
    return far


@contextlib.contextmanager
def pinned_assignment(matched):
    """The port's training forward with its Hungarian assignment replaced
    by ``matched`` ([2, T, S, B, L]: first branch, second branch; an array
    or a tensor), frame by frame. (``chip_smoke.py`` holds the same
    copy.)"""
    matched = torch.as_tensor(matched).long()
    frame = iter(range(matched.shape[1]))
    real = torch_phnet.train_assign

    def fixed(cfg, preds, *_):
        i = next(frame)
        return torch.cat([matched[0, i], matched[1, i]]).to(preds.device)

    torch_phnet.train_assign = fixed
    try:
        yield
    finally:
        torch_phnet.train_assign = real


@contextlib.contextmanager
def pinned_gates(open_):
    """The routers' output gates (the ReLU before the sigmoid: a score
    above 0.5 is an open gate) pinned to ``open_`` ([T, S, B, A] bool),
    frame by frame and stage by stage: an open gate passes the router's
    logit (a slightly negative one too), a closed one gives 0. A remat
    recompute (the backward runs under the pin too), which gives the
    forward's bits, finds its gate by its input's bytes."""
    gates = torch.as_tensor(np.asarray(open_))
    order = iter([(t, s) for t in range(gates.shape[0])
                  for s in range(gates.shape[1])])
    seen = {}
    real = torch_router.AdaptiveRouter.forward

    def forward(self, feats):
        key = feats.detach().float().numpy().tobytes()
        if key not in seen:
            seen[key] = gates[next(order)][..., None]
        z = self.logits(feats)
        return torch.sigmoid(torch.where(seen[key], z, 0.0).float())

    torch_router.AdaptiveRouter.forward = forward
    try:
        yield
    finally:
        torch_router.AdaptiveRouter.forward = real


def port_step(tc, tloss, variables, frames, labels, pin=None,
              gates=None, dtype=torch.float32):
    """One port step on the CPU (remat on, the default); with ``pin``,
    the assignment pinned to those matches, with ``gates`` the routers'
    output gates (:func:`pinned_gates`). ``dtype`` float64 runs the
    float32 model in float64 (the exact answer)."""
    default = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        model = tp.torch_model(tc, variables).to(dtype)
        model.train()
        with (pinned_assignment(pin) if pin is not None
              else contextlib.nullcontext()), (
                pinned_gates(gates) if gates is not None
                else contextlib.nullcontext()):
            outs, mem = model.train_forward(
                torch.from_numpy(frames).to(dtype),
                torch.from_numpy(labels).to(dtype))
            loss, _ = TorchCriterion(tc, tloss)(
                outs, torch.from_numpy(labels).to(dtype))
            loss.backward()  # the remat recompute under the same pins
    finally:
        torch.set_default_dtype(default)
    return dict(
        loss=loss.item(), outs=outs, mem=mem,
        matches=np.stack([outs.matched_fir.numpy(),
                          outs.matched_sec.numpy()]),
        grads={n: (p.grad if p.grad is not None else torch.zeros_like(p)
                   ).double().numpy()
               for n, p in model.named_parameters()},
        batch_stats={k: v.numpy() for k, v in model.state_dict().items()
                     if k.endswith(".mean") or k.endswith(".var")})


def port_matches(tc, variables, frames, labels) -> np.ndarray:
    """The port's matches of a training forward (no backward)."""
    model = tp.torch_model(tc, variables)
    model.train()
    with torch.no_grad():
        outs, _ = model.train_forward(torch.from_numpy(frames),
                                      torch.from_numpy(labels))
    return np.stack([outs.matched_fir.numpy(), outs.matched_sec.numpy()])


def robust_slots(labels, *runs) -> np.ndarray:
    """[2, T, S, B, L] bool: a valid target whose match is the same in
    every one of ``runs`` (each a list of [2, T, S, B, L] matches)."""
    valid = (labels[..., 1] == 1.0).transpose(1, 0, 2)[None, :, None]
    keep = np.broadcast_to(valid, runs[0][0].shape).copy()
    for matches in runs:
        keep &= np.all([m == matches[0] for m in matches], axis=0)
    return keep


def bf16_run(preset: str, chain_f32: bool = False, ulp_seeds=ULP_SEEDS):
    """Everything the bf16 step tests compare: the JAX step on the frames
    and their one-ulp copies (one a seed of ``ulp_seeds``), the port's
    free matches on the same, and the port's step pinned to JAX's matches
    on the frames and the copies."""
    jc, tc, jl, tl = configs(preset, "bfloat16", chain_f32)
    variables, frames, labels = problem(preset, tc)
    copies = [one_ulp(frames, s) for s in ulp_seeds]
    jstep = jax_step(jc, jl, variables, labels)
    ref = jstep(frames)
    jax_ulp = [jstep(f) for f in copies]
    jax_matches = [ref["matches"]] + [r["matches"] for r in jax_ulp]
    port_free = [port_matches(tc, variables, f, labels)
                 for f in [frames] + copies]
    gates = np.asarray(ref["outs"].diff) > 0.5
    got = port_step(tc, tl, variables, frames, labels, pin=ref["matches"],
                    gates=gates)
    # the spread runs without remat: the same function, 5x faster on the
    # CPU
    no_remat = dataclasses.replace(tc, remat_frames=False)
    ulp = [port_step(no_remat, tl, variables, f, labels, pin=ref["matches"],
                     gates=gates) for f in copies]
    return dict(ref=ref, got=got, ulp=ulp, jax_ulp=jax_ulp, labels=labels,
                tc=tc, tl=tl, variables=variables, frames=frames,
                robust=robust_slots(labels, jax_matches, port_free),
                port_free=port_free[0])


def control_step(run, compute_dtype: str = "bfloat16"):
    """The port's step (without remat) on ``run``'s frames, pinned to
    JAX's matches, in ``compute_dtype``: a control that the bounds must
    reject when it is a different step (float32; or run under a planted
    fault)."""
    tc = dataclasses.replace(run["tc"], remat_frames=False,
                             compute_dtype=compute_dtype)
    return port_step(tc, run["tl"], run["variables"], run["frames"],
                     run["labels"], pin=run["ref"]["matches"],
                     gates=np.asarray(run["ref"]["outs"].diff) > 0.5)


def without_mean_term(real):
    """BatchNorm's closed-form backward with its ``- mean(g)`` term
    dropped, a planted fault for the bf16 tests' controls: dx moved by
    ``r * scale * mean(g)`` per channel."""

    def backward(ctx, g, g_mean, g_var):
        dx, d_scale, d_bias, none = real(ctx, g, g_mean, g_var)
        x, _, r, scale = ctx.saved_tensors
        n = x.numel() // x.shape[1]
        shift = (r * scale * d_bias / n).reshape(
            (1, -1) + (1,) * (x.ndim - 2))
        return (dx.float() + shift).to(x.dtype), d_scale, d_bias, none

    return staticmethod(backward)


def spread(got, ulp, key):
    """The port's one-ulp spread of a scalar (``key`` "loss"), or per
    entry name of a dict (``key`` "grads", "batch_stats")."""
    if key == "loss":
        return max(abs(u["loss"] - got["loss"]) for u in ulp)
    return {n: max(np.abs(u[key][n] - x).max() for u in ulp)
            for n, x in got[key].items()}


def leaf_bound(run, name: str, factor: float) -> float:
    """The bound of gradient leaf ``name`` in a bf16 run: ``factor`` times
    the port's one-ulp spread; for the routers' conv biases, whose
    gradient is zero up to rounding and JAX's chain rounds more often
    (every product and sum of a 3x3), times the larger of the two
    packages' spreads."""
    bound = spread(run["got"], run["ulp"], "grads")[name]
    if name.endswith("conv_bias"):
        bound = max(bound, spread(run["ref"], run["jax_ulp"],
                                  "grads")[name])
    return factor * bound


def leaf_names(preset: str):
    _, tc, _, _ = configs(preset)
    from phnet_torch.models import PHNet

    return [n for n, _ in PHNet(tc, device="cpu").named_parameters()]


# -- the checks of a bf16 run (``bf16_run``), shared by the test modules ---

def check_outputs_float32(run):
    """The head's outputs reach the criterion in float32; the memory (the
    ring, or the one-frame carry) is float32."""
    for name in ("pred_fir", "pred_sec", "diff"):
        assert getattr(run["got"]["outs"], name).dtype == torch.float32
    assert all(x.dtype == torch.float32 for x in run["got"]["mem"][:-1]
               if x.is_floating_point())


def check_robust_matches(run, robust_min: float):
    """On the robust slots the port's matches equal JAX's; at least
    ``robust_min`` of the valid slots are robust."""
    robust = run["robust"]
    valid = np.broadcast_to((run["labels"][..., 1] == 1.0).transpose(
        1, 0, 2)[None, :, None], robust.shape)
    assert robust.sum() >= robust_min * valid.sum()
    np.testing.assert_array_equal(run["port_free"][robust],
                                  run["ref"]["matches"][robust])


def check_loss(run, factor: float):
    got, ref = run["got"], run["ref"]
    assert abs(got["loss"] - ref["loss"]) <= factor * spread(
        got, run["ulp"], "loss")


def check_leaf(run, name: str, factor: float):
    got, ref = run["got"]["grads"][name], run["ref"]["grads"][name]
    assert got.shape == ref.shape
    bound = leaf_bound(run, name, factor)
    assert np.abs(got - ref).max() <= bound, (np.abs(got - ref).max(),
                                              bound)


def leaves_outside(run, step, factor: float):
    """The gradient leaves of ``step`` outside the bounds of ``run``'s
    (:func:`check_leaf`'s)."""
    return [n for n, g in step["grads"].items()
            if np.abs(g - run["ref"]["grads"][n]).max()
            > leaf_bound(run, n, factor)]


def stats_outside(run, step, factor: float):
    """The running statistics of ``step`` outside ``factor`` times the
    port's one-ulp spread of each."""
    stat_spread = spread(run["got"], run["ulp"], "batch_stats")
    return [k for k, x in run["ref"]["batch_stats"].items()
            if np.abs(step["batch_stats"][k] - x).max()
            > factor * stat_spread[k]]


def check_running_stats(run, factor: float):
    """BatchNorm's running statistics float32, within ``factor`` times
    their spread."""
    got, ref = run["got"]["batch_stats"], run["ref"]["batch_stats"]
    assert ref and set(got) == set(ref)
    for k, x in got.items():
        assert x.dtype == np.float32, k
    assert not stats_outside(run, run["got"], factor)
