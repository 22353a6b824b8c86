"""Typed configuration tree and experiment presets.

Counterpart of transplat_tpu/config.py: plain dataclasses, optional YAML
overrides (yaml is imported only when a YAML path is given). Fields the JAX
package has for the TPU and the port has no use for are left out
(`RasterizeConfig.capacity`: the port's tile lists drop nothing), or
accepted and ignored (`EncoderCfg.s2d_unet`, see model/encoder.py; with
`compute_dtype="bfloat16"` refused in both packages). One field is the port's own:
`TrainerCfg.deterministic_kernels`, which the JAX package needs no switch
for (a Pallas grid runs in order, so its steps repeat their bits). `DatasetCfg` and `BoundedCfg`
carry the JAX fields and defaults; their readers are dataset/re10k.py and
dataset/view_samplers.py.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

from .loss.losses import LossCfg
from .model.adapter import GaussianAdapterCfg
from .model.decoder import DecoderCfg
from .model.encoder import EncoderCfg, OpacityMappingCfg
from .model.encoder_epipolar import EncoderEpipolarCfg


@dataclass
class DatasetCfg:
    roots: list = field(default_factory=lambda: ["datasets/re10k"])
    image_shape: tuple[int, int] = (256, 256)
    near: float = 1.0
    far: float = 100.0
    baseline_epsilon: float = 1e-3
    max_fov: float = 100.0
    make_baseline_1: bool = False
    baseline_scale_bounds: bool = False
    augment: bool = True
    skip_bad_shape: bool = True
    expected_shape: tuple[int, int] | None = (360, 640)
    test_times_per_scene: int = 1
    overfit_to_scene: str | None = None
    cameras_are_circular: bool = False


@dataclass
class BoundedCfg:
    num_context_views: int = 2
    num_target_views: int = 4
    min_distance_between_context_views: int = 45
    max_distance_between_context_views: int = 192
    min_distance_to_context_views: int = 0
    warm_up_steps: int = 150_000
    initial_min_distance_between_context_views: int = 25
    initial_max_distance_between_context_views: int = 45


@dataclass
class OptimizerCfg:
    lr: float = 2e-4
    warm_up_steps: int = 2000
    cosine_lr: bool = True
    gradient_clip_val: float = 0.5


@dataclass
class TrainerCfg:
    max_steps: int = 300_001
    # <=1: fraction of max_steps between validations; >1: absolute steps.
    val_check_interval: float = 0.05
    num_sanity_val_steps: int = 2
    val_save_media: bool = True  # validation also writes the projections and the wobble video
    batch_size: int = 2  # per device
    num_workers: int = 4  # forked data-loading worker processes (0: a prefetch thread)
    seed: int = 111123
    # Port only: training steps on the card repeat their bits (K2 and K8 in
    # their sorted modes, deterministic cuDNN; training/step.py). Not the
    # dropout switch `deterministic` of make_train_step.
    deterministic_kernels: bool = False


@dataclass
class CheckpointingCfg:
    load: str | None = None
    every_n_train_steps: int = 20_000
    save_dir: str = "outputs/checkpoints"
    pretrained_model: str | None = None
    dav2_weights: str | None = None
    lpips_weights: str | None = None


@dataclass
class TestCfg:
    output_path: str = "outputs/test"
    compute_scores: bool = True
    eval_time_skip_steps: int = 5
    save_image: bool = False
    save_video: bool = False
    save_ply: bool = False
    evaluation_index: str | None = None
    stage_timing: bool = False
    analyze: bool = False


@dataclass
class RootCfg:
    mode: str = "train"
    dataset: DatasetCfg = field(default_factory=DatasetCfg)
    view_sampler: BoundedCfg = field(default_factory=BoundedCfg)
    encoder: EncoderCfg | EncoderEpipolarCfg = field(default_factory=EncoderCfg)
    decoder: DecoderCfg = field(default_factory=DecoderCfg)
    loss: LossCfg = field(default_factory=LossCfg)
    optimizer: OptimizerCfg = field(default_factory=OptimizerCfg)
    trainer: TrainerCfg = field(default_factory=TrainerCfg)
    checkpointing: CheckpointingCfg = field(default_factory=CheckpointingCfg)
    test: TestCfg = field(default_factory=TestCfg)


def re10k_config() -> RootCfg:
    """The flagship experiment (the reference's config/experiment/re10k.yaml)."""
    return RootCfg(
        dataset=DatasetCfg(
            roots=["datasets/re10k"],
            image_shape=(256, 256),
            near=1.0,
            far=100.0,
            make_baseline_1=False,
            baseline_scale_bounds=False,
        ),
        view_sampler=BoundedCfg(),
        encoder=EncoderCfg(
            d_feature=128,
            num_depth_candidates=128,
            costvolume_unet_feat_dim=128,
            costvolume_unet_channel_mult=(1, 1, 1),
            costvolume_unet_attn_res=(4,),
            depth_unet_feat_dim=32,
            depth_unet_attn_res=(16,),
            depth_unet_channel_mult=(1, 1, 1, 1, 1),
            gaussian_adapter=GaussianAdapterCfg(0.5, 15.0, 4),
            opacity_mapping=OpacityMappingCfg(0.0, 0.0, 1),
            s2d_unet=True,
        ),
        # Black background, 16x16 tiles, float32. The JAX config sets a
        # worklist capacity here; the port's tile lists have none.
        decoder=DecoderCfg(),
        loss=LossCfg(mse_weight=1.0, lpips_weight=0.05, lpips_apply_after_step=0),
    )


def acid_config() -> RootCfg:
    cfg = re10k_config()
    cfg.dataset.roots = ["datasets/acid"]
    return cfg


def dtu_config(num_context_views: int = 2) -> RootCfg:
    cfg = re10k_config()
    cfg.dataset.roots = ["datasets/dtu"]
    cfg.dataset.test_times_per_scene = 1
    cfg.encoder = dataclasses.replace(cfg.encoder, num_context_views=num_context_views)
    return cfg


def pixelsplat_re10k_config() -> RootCfg:
    """pixelSplat on RE10K (its config/experiment/re10k.yaml with
    config/model/encoder/epipolar.yaml): the epipolar encoder at its
    published widths, three Gaussians a pixel, SH degree 4; serving and
    evaluation (its training is not ported)."""
    cfg = re10k_config()
    cfg.encoder = EncoderEpipolarCfg()  # its defaults are epipolar.yaml's
    return cfg


EXPERIMENTS = {
    "re10k": re10k_config,
    "acid": acid_config,
    "dtu": dtu_config,
    "pixelsplat_re10k": pixelsplat_re10k_config,
}


def _apply_overrides(obj: Any, overrides: dict) -> Any:
    """Recursively apply a nested dict of overrides to a dataclass tree."""
    if not dataclasses.is_dataclass(obj):
        return overrides
    updates = {}
    for key, value in overrides.items():
        current = getattr(obj, key)
        if isinstance(value, dict) and dataclasses.is_dataclass(current):
            updates[key] = _apply_overrides(current, value)
        else:
            updates[key] = tuple(value) if isinstance(value, list) and isinstance(current, tuple) else value
    return dataclasses.replace(obj, **updates)


def load_config(experiment: str = "re10k", yaml_path: str | Path | None = None, **overrides) -> RootCfg:
    """Build a config from an experiment preset + optional YAML + keyword overrides."""
    cfg = EXPERIMENTS[experiment]()
    if yaml_path is not None:
        import yaml

        with open(yaml_path) as f:
            cfg = _apply_overrides(cfg, yaml.safe_load(f) or {})
    if overrides:
        cfg = _apply_overrides(cfg, overrides)
    return cfg
