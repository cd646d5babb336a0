"""Configuration of the PyTorch port (own copy of ``phnet_tpu.config``).

The dataclasses keep the JAX package's field names and defaults for what
the port runs, so one set of keyword arguments builds the same model in
both packages: VIL-100 and OpenLane-V with all three of OpenLane's heads
(:func:`openlane_config`, the reference's ``Router4OL``;
:func:`openlane_multiscale_config`, ``Router4OLV2``;
:func:`openlane_propagate_config`, ``Router4OLV3``), in inference and in
training (:class:`TrainConfig`, :class:`LossConfig`,
``HeadConfig.decoder_dropout`` and ``router_train_chain_f32``,
``ModelConfig.train_assigner`` with the Hungarian and dynamic-k
assigners, ``ModelConfig.remat_frames``, and the readers' sampling
``TrainConfig.max_skip`` and ``samples_per_video``), with every
backbone of :class:`BackboneConfig` (ResNet-18, -34 and the Bottleneck
ResNet-50, with BatchNorm or GroupNorm, and RevCol). Fields that only
selected TPU formulations
of the same function (the stems and the max pool's backward, router
chain layouts and kernels,
stage-0 hoisting, dual-branch head stacking, remat policies, scan unroll,
the flat-matrix AdamW) are gone, and so are ``DataConfig`` (the readers
take the frame size, cut and crop from the ``ModelConfig``) and
``MemoryConfig.slots_per_frame`` (the port derives the slots from
``max_lanes``): an unknown keyword fails when the config is built, and an
unknown training assigner fails in ``__post_init__``.
``compute_dtype="bfloat16"`` is the JAX package's mixed precision (its
headline configuration and its trainers' default), in inference and in
training; the multi-scale head reads no compute dtype, as in the JAX
package, so there only the encoder computes in bf16.

The presets take keyword overrides of :class:`Config`'s fields, as the
JAX package's do, and also of :class:`ModelConfig`'s, so that
``vil100_config(compute_dtype="bfloat16")`` builds.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple, Union

QUANTIZE_MODES = ("none", "int8", "w8")
COMPUTE_DTYPES = ("float32", "bfloat16")
TRAIN_ASSIGNERS = ("hungarian", "dynamic_k")


def check_quantize(mode: str) -> str:
    """``mode`` if it is one of :data:`QUANTIZE_MODES`, else ValueError."""
    if mode not in QUANTIZE_MODES:
        raise ValueError("quantize must be one of 'none', 'int8', 'w8'; "
                         "got %r" % (mode,))
    return mode


@dataclass(frozen=True)
class LaneSpec:
    """Layout of the per-anchor lane vector: 2 cls logits, start_y,
    start_x, theta, ``n_lengths`` length fields, ``n_offsets`` xs."""

    n_offsets: int = 36
    n_lengths: int = 2  # 2 = VIL (valid + invalid), 1 = OpenLane

    @property
    def n_strips(self) -> int:
        return self.n_offsets - 1

    @property
    def header_dim(self) -> int:
        return 5 + self.n_lengths

    @property
    def dim(self) -> int:
        return self.header_dim + self.n_offsets

    @property
    def col_start_y(self) -> int:
        return 2

    @property
    def col_start_x(self) -> int:
        return 3

    @property
    def col_theta(self) -> int:
        return 4

    @property
    def col_length(self) -> int:
        return 5

    @property
    def col_invalid_length(self) -> Optional[int]:
        return 6 if self.n_lengths == 2 else None

    @property
    def col_xs(self) -> int:
        return self.header_dim


BACKBONE_KINDS = ("resnet", "revcol")
RESNET_DEPTHS = (18, 34, 50)
BACKBONE_NORMS = ("batch", "group")


@dataclass(frozen=True)
class BackboneConfig:
    """The backbone: a ResNet with the 7x7/s2 stem (``kind="resnet"``:
    BasicBlocks at depth 18 and 34, Bottlenecks at 50; BatchNorm, or
    flax's GroupNorm with ``norm="group"``), or RevCol (``kind="revcol"``,
    the reference's ``revcolV2.py``; ``revcol_tiny`` by default: columns
    of ConvNeXt blocks, ``in_channels`` wide per level). ``in_channels``
    are the stages' widths, a Bottleneck stage's output being four times
    its width. The JAX package's ``norm="batch_flax"`` is the same
    BatchNorm (same parameters, same function): its trees load into
    ``norm="batch"``. Its ``stem`` and ``pool_vjp`` only choose how the
    same function is computed and are not ported."""

    kind: str = "resnet"
    depth: int = 18
    in_channels: Tuple[int, ...] = (64, 128, 256, 512)
    norm: str = "batch"
    out_indices: Tuple[int, ...] = (1, 2, 3)
    revcol_layers: Tuple[int, ...] = (2, 2, 4, 2)
    revcol_num_subnet: int = 4
    revcol_drop_path: float = 0.1
    revcol_save_memory: bool = True

    def __post_init__(self):
        if self.kind not in BACKBONE_KINDS:
            raise ValueError(f"backbone kind must be one of {BACKBONE_KINDS},"
                             f" got {self.kind!r}")
        if self.kind == "resnet" and self.depth not in RESNET_DEPTHS:
            raise ValueError(f"ResNet depth must be one of {RESNET_DEPTHS}, "
                             f"got {self.depth!r}")
        if self.norm not in BACKBONE_NORMS:
            raise ValueError(f"backbone norm must be one of {BACKBONE_NORMS}"
                             f" (load a 'batch_flax' tree as 'batch'), got "
                             f"{self.norm!r}")
        if len(self.in_channels) != 4 or (
                self.kind == "revcol" and (len(self.revcol_layers) != 4
                                           or self.revcol_num_subnet < 1)):
            raise ValueError("the backbone takes four stage widths (and "
                             "RevCol four level depths and one column or "
                             "more)")


@dataclass(frozen=True)
class NeckConfig:
    """``out_channels`` is one width for every level or one per level (the
    multi-scale head's ``fpnV2``)."""

    in_channels: Tuple[int, ...] = (128, 256, 512)
    out_channels: Union[int, Tuple[int, ...]] = 64
    num_outs: int = 3


@dataclass(frozen=True)
class HeadConfig:
    num_priors: int = 240
    sample_points: int = 36
    refine_layers: int = 3
    fc_hidden_dim: int = 64
    num_fc: int = 2
    prior_feat_channels: int = 64
    decoder_layers: int = 2
    decoder_heads: int = 8
    decoder_ffn_dim: int = 256
    decoder_dropout: float = 0.1  # the decoder's five sites, training only
    # the second branch's anchor positions: "sine" table (VIL) or a
    # "learned" [A, d] embedding (OL, Router4OL.py:110)
    pos_encoding: str = "sine"
    pos_temperature: float = 16.0  # sine positional table
    pos_normalize: bool = True
    # OL predicts the offsets with a head of their own (Router4OL.py:78-83);
    # VIL folds them into the geometry head's output
    separate_offset_head: bool = False
    router_reduction: int = 4
    router_blocks: int = 4
    # the router chain's intermediates in bfloat16 at inference. None
    # = auto: StreamingServer turns it on above 8 streams, as the JAX
    # server does; everywhere else None is off. True / False pin it.
    router_chain_bf16: Optional[bool] = None
    # training only: the chain in float32 even when compute_dtype is
    # bfloat16 (by default a bf16 model trains its chain in bf16, as the
    # JAX package does)
    router_train_chain_f32: bool = False
    dyn_dim_factor: int = 2
    dyn_param_reduction: int = 8
    dyn_out_expand: int = 6
    # "single" (RouterV4 / Router4OL) or "multi" scale (Router4OLV2:
    # per-stage sample points over per-stage channels)
    variant: str = "single"
    # Router4OLV3's cross-frame prior propagation: the kept lanes of frame
    # t-1 come back as max_lanes extra anchor rows of frame t
    propagate_priors: bool = False
    ms_sample_points: Tuple[int, ...] = (24, 48, 96)
    ms_channels: Tuple[int, ...] = (64, 32, 16)

    @property
    def attn_dim(self) -> int:
        """Width of the memorized second-branch features: the decode width
        with the positions concatenated (single scale) or added (multi)."""
        return (self.fc_hidden_dim if self.variant == "multi"
                else 2 * self.fc_hidden_dim)


@dataclass(frozen=True)
class TestParams:
    """Inference thresholds."""

    __test__ = False  # not a pytest class

    conf_threshold: float = 0.6
    nms_thres: float = 50.0
    nms_topk: int = 8


@dataclass(frozen=True)
class MemoryConfig:
    """Temporal memory ring ``[B, S, window, max_lanes + 1, 2*hidden]``;
    ``window <= 0`` sizes the ring to the clip (VIL). The prior-propagation
    head carries one frame of ``max_lanes`` slots instead (window 1)."""

    window: int = 5


@dataclass(frozen=True)
class ModelConfig:
    img_h: int = 384
    img_w: int = 768
    lane: LaneSpec = field(default_factory=LaneSpec)
    backbone: BackboneConfig = field(default_factory=BackboneConfig)
    neck: NeckConfig = field(default_factory=NeckConfig)
    head: HeadConfig = field(default_factory=HeadConfig)
    memory: MemoryConfig = field(default_factory=MemoryConfig)
    test: TestParams = field(default_factory=TestParams)
    max_lanes: int = 8
    routing: str = "hard"  # "hard" (VIL) | "soft" (OL)
    # original-image geometry of the datasets (not read by the model): VIL
    # crops the top cut_scale * H of each image (the pipeline emits with a
    # clip's own cut, 0 where it has none), OL the top crop_size rows of
    # its org_size (H, W) images and the pipeline emits in that cropped
    # frame shifted back by crop_size rows
    cut_scale: float = 0.35
    crop_size: int = 0
    org_size: Optional[Tuple[int, int]] = None
    # "float32", or "bfloat16": the JAX package's mixed precision:
    # convolutions, dense layers and products in bf16; norm statistics,
    # the attention softmax and the router's sigmoid in f32; the router's
    # chain in f32 at inference (unless router_chain_bf16) and in bf16 in
    # training (unless head.router_train_chain_f32); f32 parameters cast
    # at use
    compute_dtype: str = "float32"
    # inference-only quantization of the DynamicConv generator chains
    # (ops/quant.py): "w8" = int8 weights dequantized into a bf16 product
    # (the w8 matmul kernel on the card), "int8" = int8 weights and
    # activations with int32 accumulation. The chains' outputs are cast
    # to the compute dtype; the rest of the model computes in it.
    quantize: str = "none"
    # training label assigner, run once a frame on the detached predictions
    # of both branches and every stage: "hungarian", the batched
    # Jonker-Volgenant solve (ops/hungarian.py), or "dynamic_k", the
    # SimOTA assignment reduced to one prior a target
    # (losses/assign.py::dynamic_k_frame)
    train_assigner: str = "hungarian"
    # recompute each frame's head in the backward (torch.utils.checkpoint)
    # instead of keeping its activations; the assignment and the memory
    # write stay outside the recomputed region
    remat_frames: bool = True

    def __post_init__(self):
        if self.routing not in ("hard", "soft"):
            raise ValueError(f"routing must be 'hard' or 'soft', got "
                             f"{self.routing!r}")
        check_quantize(self.quantize)
        if self.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype must be one of {COMPUTE_DTYPES},"
                             f" got {self.compute_dtype!r}")
        if self.train_assigner not in TRAIN_ASSIGNERS:
            raise ValueError(f"train_assigner must be one of "
                             f"{TRAIN_ASSIGNERS}, got "
                             f"{self.train_assigner!r}")
        h = self.head
        if h.variant not in ("single", "multi"):
            raise ValueError(f"head variant must be 'single' or 'multi', got "
                             f"{h.variant!r}")
        if h.pos_encoding not in ("sine", "learned"):
            raise ValueError(f"pos_encoding must be 'sine' or 'learned', got"
                             f" {h.pos_encoding!r}")
        if h.variant == "multi" and not (
                self.lane.n_lengths == 1
                and len(h.ms_sample_points) == len(h.ms_channels)
                == h.refine_layers
                and len({p * c for p, c in zip(h.ms_sample_points,
                                               h.ms_channels)}) == 1):
            raise ValueError("the multi-scale head takes the OL lane layout "
                             "(n_lengths=1) and one (sample points, "
                             "channels) pair a stage with a constant "
                             "product")

    @property
    def n_offsets(self) -> int:
        return self.lane.n_offsets

    @property
    def n_strips(self) -> int:
        return self.lane.n_strips


@dataclass(frozen=True)
class LossConfig:
    """Criterion weights of the VIL criterion (``style="blend_all"``: the
    router blends the whole per-anchor loss of the two branches)."""

    cls_weight: float = 2.5
    reg_weight: float = 0.5
    iou_weight: float = 2.0
    focal_alpha: Tuple[float, float] = (0.5, 0.5)
    focal_gamma: float = 2.0
    iou_length: float = 15.0  # +/- band in px of the line IoU
    # "blend_all" (VIL) or "blend_cls" (OL: the router blends only the cls
    # loss; reg and IoU of both branches are summed)
    style: str = "blend_all"
    # OL's slope-adaptive LaneIoU (CLRerNet) in place of the line IoU, with
    # its default geometry 400 x 960, not the model's image size
    use_lane_iou: bool = False
    lane_iou_width: float = 7.5 / 768.0
    lane_iou_img_h: int = 400
    lane_iou_img_w: int = 960

    def __post_init__(self):
        if self.style not in ("blend_all", "blend_cls"):
            raise ValueError(f"style must be 'blend_all' or 'blend_cls', got"
                             f" {self.style!r}")


@dataclass(frozen=True)
class TrainConfig:
    epochs: int = 50
    train_batch: int = 1
    sampled_frames: int = 16
    learning_rate: float = 5e-4
    solver: str = "adamw"  # "adamw" | "sgd" (Nesterov)
    momentum: Tuple[float, float] = (0.9, 0.999)
    weight_decay: float = 1e-3
    max_skip: int = 5  # the readers' first largest gap between frames
    skip_increment: int = 5  # the max_skip curriculum's step
    max_training_skip: int = 100
    epochs_per_increment: int = 2
    samples_per_video: int = 2  # clips drawn from each video an epoch
    epoch_per_test: int = 5  # periodic checkpoints
    seed: int = 3407
    grad_clip_norm: float = 0.0  # 0 = off
    accum_steps: int = 1  # micro-batches per optimizer update
    loss: LossConfig = field(default_factory=LossConfig)

    def __post_init__(self):
        if self.solver not in ("adamw", "sgd"):
            raise ValueError(f"unknown solver {self.solver!r}")
        if self.accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, got "
                             f"{self.accum_steps}")


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)


def vil100_config(**overrides) -> Config:
    """Active VIL-100 configuration (reference ``options/optionsV3.py``)."""
    model = ModelConfig(
        lane=LaneSpec(n_offsets=36, n_lengths=2),
        backbone=BackboneConfig(),
        neck=NeckConfig(in_channels=(128, 256, 512), out_channels=64,
                        num_outs=3),
        head=HeadConfig(),
        memory=MemoryConfig(window=0),  # unbounded
        test=TestParams(conf_threshold=0.6, nms_thres=50.0, nms_topk=8),
        max_lanes=8,
        routing="hard",
        cut_scale=0.35,
    )
    train = TrainConfig(
        epochs=50,
        learning_rate=5e-4,
        weight_decay=1e-3,
        epochs_per_increment=2,
        loss=LossConfig(cls_weight=2.5, reg_weight=0.5, iou_weight=2.0,
                        focal_alpha=(0.5, 0.5), style="blend_all"),
    )
    return _with_overrides(Config(model=model, train=train), overrides)


def _with_overrides(cfg: Config, overrides) -> Config:
    """``cfg`` with keyword overrides of its own fields (``model``,
    ``train``) and of its model's."""
    model_keys = {f.name for f in dataclasses.fields(ModelConfig)}
    model_kw = {k: overrides.pop(k) for k in list(overrides)
                if k in model_keys}
    if model_kw:
        cfg = dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, **model_kw))
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def openlane_config(n_offsets: int = 72, **overrides) -> Config:
    """OpenLane-V configuration (reference ``options/options4OL.py`` with
    the 72 offsets of ``options/options4OLV3.py``): the OL lane layout, a
    learned positional embedding, a separate offset head, soft routing, a
    memory window of 5 frames, 4 lanes kept at confidence 0.5."""
    model = ModelConfig(
        lane=LaneSpec(n_offsets=n_offsets, n_lengths=1),
        backbone=BackboneConfig(),
        neck=NeckConfig(in_channels=(128, 256, 512), out_channels=64,
                        num_outs=3),
        head=HeadConfig(pos_encoding="learned", separate_offset_head=True),
        memory=MemoryConfig(window=5),
        test=TestParams(conf_threshold=0.5, nms_thres=50.0, nms_topk=4),
        max_lanes=4,
        routing="soft",
        cut_scale=0.0,
        crop_size=480,
        org_size=(1280, 1920),
    )
    train = TrainConfig(
        epochs=50,
        learning_rate=5e-4,
        weight_decay=5e-4,
        epochs_per_increment=15,
        max_skip=1,
        skip_increment=1,
        samples_per_video=1,
        loss=LossConfig(cls_weight=8.0, reg_weight=0.5, iou_weight=1.5,
                        focal_alpha=(0.1, 0.9), style="blend_cls",
                        use_lane_iou=True),
    )
    return _with_overrides(Config(model=model, train=train), overrides)


def openlane_multiscale_config(n_offsets: int = 72, **overrides) -> Config:
    """Multi-scale OpenLane-V configuration (reference ``Router4OLV2``, run
    by ``testOLV3.py`` with ``options/options4OLV3.py``): neck levels
    (64, 128, 256) -> (16, 32, 64) from the backbone's first three stages,
    per-stage sample points (24, 48, 96) over channels (64, 32, 16), a
    256-wide decode and decoder (ffn 512), DynamicConv generators reduced
    by 4, sine positions at temperature 64 without normalization, hard
    routing at inference. The JAX package's multi-scale head fixes the
    last three to these values; the port's head reads them from here."""
    base = openlane_config(n_offsets=n_offsets)
    model = dataclasses.replace(
        base.model,
        backbone=BackboneConfig(out_indices=(0, 1, 2)),
        neck=NeckConfig(in_channels=(64, 128, 256), out_channels=(16, 32, 64),
                        num_outs=3),
        head=HeadConfig(variant="multi", fc_hidden_dim=256,
                        decoder_ffn_dim=512, dyn_param_reduction=4,
                        pos_encoding="sine",
                        pos_temperature=64.0, pos_normalize=False,
                        separate_offset_head=False,
                        ms_sample_points=(24, 48, 96),
                        ms_channels=(64, 32, 16)),
        routing="hard",
    )
    return _with_overrides(dataclasses.replace(base, model=model), overrides)


def openlane_propagate_config(n_offsets: int = 72, **overrides) -> Config:
    """Prior-propagation OpenLane-V configuration (reference
    ``Router4OLV3.py``): the OL preset with ``propagate_priors``: K =
    ``max_lanes`` propagated prior slots, "_last" head stacks, per-row MLP
    routers, a one-frame memory of the kept rows with no mean-negative
    row."""
    base = openlane_config(n_offsets=n_offsets)
    model = dataclasses.replace(
        base.model,
        head=dataclasses.replace(base.model.head, propagate_priors=True),
        memory=MemoryConfig(window=1))
    return _with_overrides(dataclasses.replace(base, model=model), overrides)
