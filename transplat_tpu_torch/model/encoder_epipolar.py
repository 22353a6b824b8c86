"""EncoderEpipolar: pixelSplat's encoder (Charatan et al., CVPR 2024, arXiv
2312.12337; config/model/encoder/epipolar.yaml), posed context images ->
three world Gaussians a pixel, for serving and evaluation.

forward runs five stages, each inside a span of its name (utils/trace.py),
then the Gaussian adapter stage that it shares with EncoderTranSplat:

  epipolar_1_backbone   ResNet-50 (stem and layers 1-3, each projected to
                        512 channels and resized to the image) plus DINO
                        ViT-B/8 (a global token over every pixel, each patch
                        token over its 8 x 8 pixels); Linear(ReLU(sum)) to
                        d_feature
  epipolar_2_sample     a 4 x 4 stride-4 convolution; each ray of the low
                        grid has its segment [near, far] projected into the
                        other view (geometry/epipolar.py `project_rays`) and
                        sampled there at num_samples points; each sample's
                        depth along the ray (triangulated), clamped to
                        [near, far], as relative disparity, encoded by sines of
                        num_octaves octaves and a Linear, is added to it
  epipolar_3_attention  num_layers pre-norm layers: the ray's feature attends
                        to its samples (not normed), then pixelSplat's
                        ConvFeedForward over the low grid: a residual pair of
                        7 x 7 convolutions plus an ImageSelfAttention (4 x 4
                        patches as tokens, a self-attention transformer, a
                        stride-4 transposed convolution back)
  epipolar_4_upscale    a stride-4 transposed convolution, a residual pair of
                        7 x 7 convolutions, plus ReLU(7 x 7 conv of the image)
  epipolar_5_depth      32 depth buckets a pixel (softmax) with offsets
                        (sigmoid); the gaussians_per_pixel most probable
                        buckets give the depths and densities; the raw
                        Gaussian channels
  encoder_5_gaussian_adapter  (model/encoder.py `adapt_stage`)

The attention is computed in the samples' space: with W_q, W_k, W_v and
W_o per head, q.(W_k z) = (W_k^T q).z and sum_s a_s W_v z_s = W_v (sum_s a_s
z_s), so the key and value projections of the 32 samples of every ray are
never formed: the same products, reassociated (a few GFLOP a request in
place of ~0.14 TFLOP).

Serving is deterministic: the three buckets of largest probability
(pixelSplat samples them at training time, which is not ported: training
mode raises). The counters `epipolar.rays` and `epipolar.rays_on_image`
count the low-grid rays and those whose segment meets the other image; the
latter is kept on the card and read when the counters are read
(utils/trace.py `count_on_device`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch
from torch import nn
from torch.nn import functional as F

from ..geometry.epipolar import depth_to_relative_disparity, project_rays, triangulate_depth
from ..geometry.projection import get_world_rays, sample_image_grid
from ..utils.trace import count, count_on_device
from .adapter import GaussianAdapterCfg
from .dav2.vit import DinoVisionTransformer
from .depth_predictor import stage_span
from .encoder import OpacityMappingCfg, adapt_stage
from .resnet import ResNet50
from .types import Gaussians

STAGES = [
    "epipolar_1_backbone",
    "epipolar_2_sample",
    "epipolar_3_attention",
    "epipolar_4_upscale",
    "epipolar_5_depth",
    "encoder_5_gaussian_adapter",
]

# DINO (v1) ViTs by the name of their torch.hub entry: width, blocks, heads,
# patch; pretrained at 224^2.
DINO_MODELS = {"dino_vitb8": dict(embed_dim=768, depth=12, num_heads=12, patch_size=8)}
DINO_PRETRAIN_SIZE = 224


@dataclass(frozen=True)
class BackboneDinoCfg:
    model: str = "dino_vitb8"
    d_out: int = 512


@dataclass(frozen=True)
class ImageSelfAttentionCfg:
    patch_size: int = 4
    num_octaves: int = 10
    num_layers: int = 2
    num_heads: int = 4
    d_token: int = 128
    d_dot: int = 128
    d_mlp: int = 256


@dataclass(frozen=True)
class EpipolarTransformerCfg:
    self_attention: ImageSelfAttentionCfg = field(default_factory=ImageSelfAttentionCfg)
    num_octaves: int = 10
    num_layers: int = 2
    num_heads: int = 4
    num_samples: int = 32
    d_dot: int = 128
    d_mlp: int = 256
    downscale: int = 4


@dataclass(frozen=True)
class EncoderEpipolarCfg:
    d_feature: int = 128
    num_monocular_samples: int = 32
    num_surfaces: int = 1
    gaussians_per_pixel: int = 3
    num_context_views: int = 2
    backbone: BackboneDinoCfg = field(default_factory=BackboneDinoCfg)
    epipolar_transformer: EpipolarTransformerCfg = field(default_factory=EpipolarTransformerCfg)
    gaussian_adapter: GaussianAdapterCfg = field(default_factory=GaussianAdapterCfg)
    opacity_mapping: OpacityMappingCfg = field(default_factory=OpacityMappingCfg)

    def __post_init__(self):
        if self.num_surfaces != 1:
            raise NotImplementedError("num_surfaces > 1 is not implemented")
        if self.num_context_views != 2:
            raise NotImplementedError("pixelSplat's epipolar sampler pairs two context views")
        if self.gaussians_per_pixel > self.num_monocular_samples:
            raise ValueError("gaussians_per_pixel exceeds the depth buckets")
        if self.backbone.model not in DINO_MODELS:
            raise ValueError(f"backbone.model {self.backbone.model!r}: expected one of {sorted(DINO_MODELS)}")

    @property
    def torch_dtype(self) -> None:
        """The modules' compute dtype: float32."""
        return None


def _mlp(d_in: int, d_hidden: int, d_out: int) -> nn.Sequential:
    return nn.Sequential(nn.Linear(d_in, d_hidden), nn.ReLU(), nn.Linear(d_hidden, d_out))


class BackboneDino(nn.Module):
    """pixelSplat's `BackboneDino`: the ResNet-50's four features, each
    projected (1 x 1) to d_out and resized bilinearly (align corners) to the
    image, summed; plus the ViT's final tokens through two MLPs (768 ->
    768 -> d_out), the class token's over every pixel and each patch
    token's over its patch's pixels."""

    def __init__(self, cfg: BackboneDinoCfg):
        super().__init__()
        vit = DINO_MODELS[cfg.model]
        self.patch_size = vit["patch_size"]
        self.resnet = ResNet50()
        self.projections = nn.ModuleList(nn.Conv2d(c, cfg.d_out, 1) for c in self.resnet.channels)
        self.vit = DinoVisionTransformer(vit["embed_dim"], vit["depth"], vit["num_heads"], vit["patch_size"],
                                         DINO_PRETRAIN_SIZE, layer_scale=False)
        self.global_mlp = _mlp(vit["embed_dim"], vit["embed_dim"], cfg.d_out)
        self.local_mlp = _mlp(vit["embed_dim"], vit["embed_dim"], cfg.d_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (N, 3, H, W) -> features (N, H, W, d_out), channels last."""
        n, _, h, w = x.shape
        p = self.patch_size
        total = None
        for proj, f in zip(self.projections, self.resnet(x)):
            f = F.interpolate(proj(f), size=(h, w), mode="bilinear", align_corners=True)
            total = f if total is None else total + f
        tokens = self.vit.final_tokens(x.permute(0, 2, 3, 1))
        glob = self.global_mlp(tokens[:, 0])  # (N, d)
        local = self.local_mlp(tokens[:, 1:]).reshape(n, h // p, 1, w // p, 1, -1)
        out = total.permute(0, 2, 3, 1).reshape(n, h // p, p, w // p, p, -1) + local
        return (out + glob[:, None, None, None, None]).reshape(n, h, w, -1)


def positional_encoding(x: torch.Tensor, octaves: int) -> torch.Tensor:
    """x (...) -> (..., 2 octaves): sin(2 pi 2^k x + phase), k = 0 .. octaves - 1,
    phases 0 and pi / 2, octave-major (pixelSplat's PositionalEncoding)."""
    freqs = 2 * math.pi * 2.0 ** torch.arange(octaves, dtype=x.dtype, device=x.device)
    phases = torch.tensor([0.0, 0.5 * math.pi], dtype=x.dtype, device=x.device)
    return torch.sin(x[..., None, None] * freqs[:, None] + phases).flatten(-2)


class SelfAttentionBlock(nn.Module):
    """x <- x + Attn(LN(x)); x <- x + FF(LN(x)) over a sequence of tokens:
    heads of d_dot, a qkv projection without bias, a GELU MLP."""

    def __init__(self, d: int, heads: int, d_dot: int, d_mlp: int):
        super().__init__()
        self.heads, self.d_dot = heads, d_dot
        self.attn_norm = nn.LayerNorm(d)
        self.to_qkv = nn.Linear(d, 3 * heads * d_dot, bias=False)
        self.to_out = nn.Linear(heads * d_dot, d)
        self.ff_norm = nn.LayerNorm(d)
        self.ff_1 = nn.Linear(d, d_mlp)
        self.ff_2 = nn.Linear(d_mlp, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (N, T, d) -> (N, T, d)."""
        n, t, _ = x.shape
        q, k, v = self.to_qkv(self.attn_norm(x)).view(n, t, 3, self.heads, self.d_dot).permute(2, 0, 3, 1, 4)
        a = F.scaled_dot_product_attention(q, k, v)  # scale d_dot^-1/2
        x = x + self.to_out(a.transpose(1, 2).reshape(n, t, -1))
        return x + self.ff_2(F.gelu(self.ff_1(self.ff_norm(x))))


class ImageSelfAttention(nn.Module):
    """pixelSplat's ImageSelfAttention: patch_size^2 patches as tokens
    (a strided convolution, ReLU), plus a Linear of the sines of their
    centres (x, then y, in [0, 1]), through num_layers self-attention
    blocks, back to the grid by a transposed convolution."""

    def __init__(self, cfg: ImageSelfAttentionCfg, d_in: int, d_out: int):
        super().__init__()
        self.cfg = cfg
        self.positions = nn.Linear(4 * cfg.num_octaves, cfg.d_token)
        self.patch_embedder = nn.Conv2d(d_in, cfg.d_token, cfg.patch_size, stride=cfg.patch_size)
        self.blocks = nn.ModuleList(SelfAttentionBlock(cfg.d_token, cfg.num_heads, cfg.d_dot, cfg.d_mlp)
                                    for _ in range(cfg.num_layers))
        self.resampler = nn.ConvTranspose2d(cfg.d_token, d_out, cfg.patch_size, stride=cfg.patch_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (N, d_in, H, W) -> (N, d_out, H, W)."""
        tokens = F.relu(self.patch_embedder(x))
        n, c, nh, nw = tokens.shape
        xy, _ = sample_image_grid((nh, nw), device=x.device, dtype=x.dtype)
        pe = self.positions(positional_encoding(xy, self.cfg.num_octaves).flatten(-2))  # (nh, nw, c)
        tokens = tokens.flatten(2).transpose(1, 2) + pe.view(1, nh * nw, c)
        for block in self.blocks:
            tokens = block(tokens)
        return self.resampler(tokens.transpose(1, 2).reshape(n, c, nh, nw))


class ConvFeedForward(nn.Module):
    """pixelSplat's ConvFeedForward, the epipolar layers' feed-forward over
    the low grid: conv7(GELU(conv7 x)) + ImageSelfAttention(x)."""

    def __init__(self, cfg: ImageSelfAttentionCfg, d: int, d_hidden: int):
        super().__init__()
        self.conv_1 = nn.Conv2d(d, d_hidden, 7, padding=3)
        self.conv_2 = nn.Conv2d(d_hidden, d, 7, padding=3)
        self.self_attention = ImageSelfAttention(cfg, d, d)

    def forward(self, x: torch.Tensor, shape) -> torch.Tensor:
        """x (n hl wl, d), rays in (image, row, column) order, shape (n, hl,
        wl) -> (n hl wl, d)."""
        n, hl, wl = shape
        f = x.view(n, hl, wl, -1).permute(0, 3, 1, 2).contiguous()  # NCHW for cuDNN's 7 x 7 convolutions
        y = self.conv_2(F.gelu(self.conv_1(f))) + self.self_attention(f)
        return y.permute(0, 2, 3, 1).reshape(n * hl * wl, -1)


class EpipolarLayer(nn.Module):
    """x <- x + Attn(LN(x), z); x <- x + FF(LN(x)): one query token (the ray's
    feature) over its samples z; q and kv projections without bias; FF the
    ConvFeedForward over the rays' grid."""

    def __init__(self, d: int, heads: int, d_dot: int, d_mlp: int, self_attention: ImageSelfAttentionCfg):
        super().__init__()
        self.heads, self.d_dot = heads, d_dot
        self.attn_norm = nn.LayerNorm(d)
        self.to_q = nn.Linear(d, heads * d_dot, bias=False)
        self.to_kv = nn.Linear(d, 2 * heads * d_dot, bias=False)
        self.to_out = nn.Linear(heads * d_dot, d)
        self.ff_norm = nn.LayerNorm(d)
        self.ff = ConvFeedForward(self_attention, d, d_mlp)

    def forward(self, x: torch.Tensor, z: torch.Tensor, shape) -> torch.Tensor:
        """x (N, d), z (N, S, d), N = n hl wl rays of the grid `shape` (n, hl,
        wl) -> (N, d); the attention in the samples' space (module docstring)."""
        h, e, d = self.heads, self.d_dot, x.shape[-1]
        w_q = self.to_q.weight.view(h, e, d)
        w_k, w_v = self.to_kv.weight.view(2, h, e, d).unbind(0)
        w_o = self.to_out.weight.view(d, h, e)
        # q_h . (W_k,h z) = (W_k,h^T W_q,h LN(x)) . z: one product for every head.
        m_qk = torch.matmul(w_q.transpose(1, 2), w_k)  # (h, d, d): W_q,h^T W_k,h
        q = torch.matmul(self.attn_norm(x), m_qk.permute(1, 0, 2).reshape(d, h * d)).view(-1, h, d)
        attn = torch.softmax(torch.bmm(q, z.transpose(1, 2)) * e**-0.5, dim=-1)  # (N, h, S)
        zbar = torch.bmm(attn, z)  # (N, h, d): each head's weighted samples
        # W_o (W_v,h zbar_h) over the heads: one product with (W_o,h W_v,h)^T stacked.
        m_vo = torch.matmul(w_o.permute(1, 0, 2), w_v)  # (h, d, d): W_o,h W_v,h
        x = x + F.linear(zbar.reshape(-1, h * d), m_vo.permute(1, 0, 2).reshape(d, h * d), self.to_out.bias)
        return x + self.ff(self.ff_norm(x), shape)


class EpipolarTransformer(nn.Module):
    def __init__(self, cfg: EpipolarTransformerCfg, d: int):
        super().__init__()
        self.cfg = cfg
        self.downscaler = nn.Conv2d(d, d, cfg.downscale, stride=cfg.downscale)
        self.depth_encoding = nn.Linear(2 * cfg.num_octaves, d)
        self.layers = nn.ModuleList(EpipolarLayer(d, cfg.num_heads, cfg.d_dot, cfg.d_mlp, cfg.self_attention)
                                    for _ in range(cfg.num_layers))
        self.upscaler = nn.ConvTranspose2d(d, d, cfg.downscale, stride=cfg.downscale)
        self.refine_1 = nn.Conv2d(d, 2 * d, 7, padding=3)
        self.refine_2 = nn.Conv2d(2 * d, d, 7, padding=3)

    def sample(self, low: torch.Tensor, extrinsics, intrinsics, near, far) -> tuple[torch.Tensor, torch.Tensor]:
        """low (b v, d, hl, wl) -> (the rays' own features (b v hl wl, d), their
        samples (b v hl wl, S, d)). View 0's rays sample view 1 and back.

        The geometry (rays, segments, sample points, depths, relative
        disparities) runs in float64: a far sample's two rays are all but
        parallel, and its depth moves ~1e4 times as far as its image point,
        so float32 rounding of the point alone would turn the encoding's
        highest octaves (2 pi 2^9 a unit of disparity) into noise."""
        b, v = extrinsics.shape[:2]
        _, d, hl, wl = low.shape
        s = self.cfg.num_samples
        extr, intr = extrinsics.double(), intrinsics.double()
        near, far = near.double(), far.double()
        xy, _ = sample_image_grid((hl, wl), device=low.device, dtype=torch.float64)
        xy = xy.reshape(1, 1, hl * wl, 2)
        origins, directions = get_world_rays(xy, extr[:, :, None], intr[:, :, None])  # (b, v, r, 3)
        other = [1, 0]
        o_extr, o_intr = extr[:, other, None], intr[:, other, None]
        xy_min, xy_max, on_image = project_rays(origins, directions, o_extr, o_intr, near[..., None], far[..., None])
        count("epipolar.rays", on_image.numel())
        count_on_device("epipolar.rays_on_image", on_image.sum())
        on = on_image[..., None]
        xy_min = torch.where(on, xy_min, torch.zeros_like(xy_min))
        xy_max = torch.where(on, xy_max, torch.zeros_like(xy_max))
        t = (torch.arange(s, device=low.device, dtype=torch.float64) + 0.5) / s
        xy_s = xy_min[..., None, :] + t[:, None] * (xy_max - xy_min)[..., None, :]  # (b, v, r, s, 2)
        grid = (2.0 * xy_s - 1.0).to(low.dtype).reshape(b * v, hl * wl * s, 1, 2)
        src = low.view(b, v, d, hl, wl)[:, other].reshape(b * v, d, hl, wl)
        feats = F.grid_sample(src, grid, mode="bilinear", padding_mode="zeros", align_corners=False)
        feats = feats.view(b, v, d, hl * wl, s).permute(0, 1, 3, 4, 2) * on[..., None]  # (b, v, r, s, d)
        depth = triangulate_depth(origins[..., None, :], directions[..., None, :], xy_s, o_extr[..., None, :, :],
                                  o_intr[..., None, :, :])
        lo, hi = near[..., None, None], far[..., None, None]
        depth = torch.minimum(torch.maximum(depth.nan_to_num(nan=float("inf")), lo), hi)
        rel = depth_to_relative_disparity(depth, lo, hi).to(low.dtype)
        z = (feats + self.depth_encoding(positional_encoding(rel, self.cfg.num_octaves))).reshape(b * v * hl * wl, s, d)
        return low.permute(0, 2, 3, 1).reshape(-1, d), z

    def attend(self, x: torch.Tensor, z: torch.Tensor, shape) -> torch.Tensor:
        """x (n hl wl, d), z (n hl wl, S, d) over the grid `shape` (n, hl, wl)."""
        for layer in self.layers:
            x = layer(x, z, shape)
        return x

    def upscale(self, x: torch.Tensor, shape) -> torch.Tensor:
        """x (b v hl wl, d) -> (b v, d, H, W): the transposed convolution and the
        residual refinement."""
        n, hl, wl = shape
        y = self.upscaler(x.view(n, hl, wl, -1).permute(0, 3, 1, 2).contiguous())
        return y + self.refine_2(F.gelu(self.refine_1(y)))


class EncoderEpipolar(nn.Module):
    stages = STAGES

    def __init__(self, cfg: EncoderEpipolarCfg = EncoderEpipolarCfg(), device="cuda"):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_feature
        self.backbone = BackboneDino(cfg.backbone)
        self.projection = nn.Linear(cfg.backbone.d_out, d)
        self.epipolar = EpipolarTransformer(cfg.epipolar_transformer, d)
        self.skip = nn.Conv2d(3, d, 7, padding=3)
        self.depth_head = nn.Linear(d, 2 * cfg.num_monocular_samples)
        self.to_gaussians = nn.Linear(d, cfg.num_surfaces * (2 + cfg.gaussian_adapter.d_in))
        self.to(device)
        self.eval()

    def depths(self, features: torch.Tensor, near: torch.Tensor, far: torch.Tensor):
        """ReLU'd features (b, v, H, W, d) -> depths, densities and the buckets
        (b, v, H W, k) of the k = gaussians_per_pixel most probable buckets
        (descending), and the buckets' probabilities (b, v, H, W, n)."""
        b, v, h, w, _ = features.shape
        n, k = self.cfg.num_monocular_samples, self.cfg.gaussians_per_pixel
        logits, offsets = self.depth_head(features).split(n, dim=-1)
        pdf = torch.softmax(logits, dim=-1)
        prob, index = pdf.topk(k, dim=-1)
        density = prob / pdf.sum(-1, keepdim=True)
        rel = (index + torch.sigmoid(offsets).gather(-1, index)) / n
        lo, hi = near[:, :, None, None, None], far[:, :, None, None, None]
        depth = 1.0 / ((1.0 - rel) * (1.0 / lo - 1.0 / hi) + 1.0 / hi)
        return depth.reshape(b, v, h * w, k), density.reshape(b, v, h * w, k), index.reshape(b, v, h * w, k), pdf

    def forward(
        self,
        images: torch.Tensor,  # (b, v, H, W, 3) in [0, 1]
        intrinsics: torch.Tensor,  # (b, v, 3, 3) normalized
        extrinsics: torch.Tensor,  # (b, v, 4, 4) camera-to-world
        near: torch.Tensor,  # (b, v)
        far: torch.Tensor,  # (b, v)
        global_step: int = 0,  # position in the opacity warm-up
        generator: torch.Generator | None = None,  # accepted for the training step's call; unused
        deterministic_kernels: bool = False,  # accepted for the same; nothing here draws or sorts
        return_aux: bool = False,
        stage=None,  # optional tag -> context manager entered inside each stage's span
    ):
        """Gaussians (b, v H W k, ...) in (view, pixel, sample) order; with
        `return_aux`, (Gaussians, aux) where aux holds `depths` (b, v, H, W,
        k), `pdf` (b, v, H, W, n), `scales`, `rotations` and the attended
        low-grid `features` (b, v, hl, wl, d)."""
        if self.training:
            raise NotImplementedError("pixelSplat's training (sampled depths and their gradients) is not ported")
        cfg = self.cfg
        b, v, h, w, _ = images.shape
        down = cfg.epipolar_transformer.downscale
        # The convolutions take contiguous NCHW: a channels-last view sends
        # cuDNN's float32 7 x 7 convolutions to a generic NHWC engine, ~2x
        # slower on an H100 (85 against 38 ms a request's upscale stage).
        image = images.permute(0, 1, 4, 2, 3).reshape(b * v, 3, h, w).contiguous()

        with stage_span("epipolar_1_backbone", stage):
            features = self.projection(F.relu(self.backbone(image)))  # (b v, H, W, d)
        with stage_span("epipolar_2_sample", stage):
            low = self.epipolar.downscaler(features.permute(0, 3, 1, 2).contiguous())
            x, z = self.epipolar.sample(low, extrinsics, intrinsics, near, far)
        with stage_span("epipolar_3_attention", stage):
            x = self.epipolar.attend(x, z, (b * v, h // down, w // down))
        with stage_span("epipolar_4_upscale", stage):
            y = self.epipolar.upscale(x, (b * v, h // down, w // down))
            y = F.relu(y + F.relu(self.skip(image)))  # the heads take ReLU(features)
        with stage_span("epipolar_5_depth", stage):
            depths, densities, _, pdf = self.depths(y.permute(0, 2, 3, 1).view(b, v, h, w, -1), near, far)
            # A 1 x 1 convolution: one channel of consecutive pixels contiguous, as the adapter kernel reads best.
            raw = F.conv2d(y, self.to_gaussians.weight[:, :, None, None], self.to_gaussians.bias)
            raw = raw.view(b, v, -1, h * w).transpose(2, 3)

        with stage_span("encoder_5_gaussian_adapter", stage):
            out = adapt_stage(cfg, extrinsics, intrinsics, raw, depths, densities, global_step, (h, w),
                              with_aux=return_aux)
            gaussians = Gaussians(out["means"], out["covariances"], out["harmonics"], out["opacities"])
        if not return_aux:
            return gaussians
        aux = {
            "depths": depths.reshape(b, v, h, w, -1),
            "pdf": pdf,
            "scales": out["scales"],
            "rotations": out["rotations"],
            "features": x.view(b, v, h // down, w // down, -1),
        }
        return gaussians, aux
