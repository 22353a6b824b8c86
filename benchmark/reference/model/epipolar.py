"""The plain pixelSplat encoder (Charatan et al., arXiv 2312.12337; its
config/model/encoder/epipolar.yaml and config/experiment/re10k.yaml), for
the benchmark's comparison: float32 PyTorch, the equations as written, no
reassociation and no kernels. Parameter names and shapes are the program's
(transplat_tpu_torch/model/encoder_epipolar.py), so that both take one set
of seeded weights; nothing of the program is imported.

  1. backbone: ResNet-50 without max-pool (the stem, layers 1-3, each
     projected to 512 by a 1 x 1 convolution and resized bilinearly with
     aligned corners to the image, summed) + DINO ViT-B/8 (the final norm of
     the last block's tokens; the class token's MLP repeated over every
     pixel, each patch token's over its 8 x 8 pixels); F = Linear(ReLU(sum)).
  2. sample: a 4 x 4 stride-4 convolution to 64 x 64; each ray's segment
     [near, far] cut to the other camera's frustum (geometry/rays.py),
     sampled at (k + 0.5) / 32 of the way between its ends' image points,
     bilinearly with zero padding; a ray whose segment misses has zero
     samples; each sample's depth along the ray, clamped to [near, far], as
     relative disparity, sin(2 pi 2^k d + {0, pi / 2}) for 10 octaves, a
     Linear(20 -> 128) added. The geometry of this stage runs in float64.
  3. attention, twice: x += to_out(softmax(q k^T / sqrt(128)) v) with q =
     to_q(LN(x)), (k, v) = to_kv(z) split, 4 heads; x += FF(LN(x)), FF
     pixelSplat's ConvFeedForward over the 64 x 64 grid of rays: conv7(GELU(
     conv7 f)) + ImageSelfAttention(f), the latter 4 x 4 patches embedded by
     a strided convolution and ReLU, plus Linear(sines of the patch centres,
     10 octaves, x then y), two self-attention blocks (4 heads of 128, MLP
     256), a transposed 4 x 4 stride-4 convolution back to the grid.
  4. upscale: transposed 4 x 4 stride-4 convolution, y += conv7(GELU(conv7
     y)), F = y + ReLU(conv7(image)).
  5. depth: Linear(ReLU(F)) -> 32 logits, 32 offsets; pdf = softmax; the 3
     buckets of largest probability (descending); density = pdf_i / sum pdf;
     depth = 1 / ((1 - (i + sigmoid offset_i) / 32) (1 / near - 1 / far) +
     1 / far); raw = Linear(ReLU(F)).
  then the Gaussian adapter (adapter.py) for each of a pixel's 3 depths,
  opacity map_pdf_to_opacity(density) / 3, in (view, pixel, sample) order.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch
from torch import nn
from torch.nn import functional as F

from ..geometry.projection import get_world_rays, sample_image_grid
from ..geometry.rays import depth_along_ray, project_rays
from ..ops.interpolate import resize_bicubic_torch
from .adapter import GaussianAdapterCfg, adapt_gaussians
from .encoder import OpacityMappingCfg, map_pdf_to_opacity
from .types import Gaussians

VIT = dict(embed_dim=768, depth=12, num_heads=12, patch_size=8, pretrain_size=224)


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


# ---- ResNet-50 (torchvision's names) ---------------------------------------------


class Bottleneck(nn.Module):
    def __init__(self, cin: int, width: int, stride: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, width, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(width)
        self.conv3 = nn.Conv2d(width, 4 * width, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(4 * width)
        self.downsample = None
        if stride != 1 or cin != 4 * width:
            self.downsample = nn.Sequential(nn.Conv2d(cin, 4 * width, 1, stride, bias=False), nn.BatchNorm2d(4 * width))

    def forward(self, x):
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return torch.relu(y + (x if self.downsample is None else self.downsample(x)))


class ResNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.layer1 = nn.Sequential(Bottleneck(64, 64, 1), Bottleneck(256, 64, 1), Bottleneck(256, 64, 1))
        self.layer2 = nn.Sequential(Bottleneck(256, 128, 2), *[Bottleneck(512, 128, 1) for _ in range(3)])
        self.layer3 = nn.Sequential(Bottleneck(512, 256, 2), *[Bottleneck(1024, 256, 1) for _ in range(5)])

    def forward(self, x):
        f0 = torch.relu(self.bn1(self.conv1(x)))
        f1 = self.layer1(f0)
        f2 = self.layer2(f1)
        f3 = self.layer3(f2)
        return [f0, f1, f2, f3]


# ---- DINO ViT-B/8 ------------------------------------------------------------------


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        n, t, c = x.shape
        qkv = self.qkv(x).reshape(n, t, 3, self.heads, c // self.heads).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        a = torch.softmax(q @ k.transpose(-2, -1) * (c // self.heads) ** -0.5, dim=-1)
        return self.proj((a @ v).transpose(1, 2).reshape(n, t, c))


class Block(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp_fc1 = nn.Linear(dim, 4 * dim)
        self.mlp_fc2 = nn.Linear(4 * dim, dim)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp_fc2(F.gelu(self.mlp_fc1(self.norm2(x))))


class ViT(nn.Module):
    def __init__(self):
        super().__init__()
        dim, side = VIT["embed_dim"], VIT["pretrain_size"] // VIT["patch_size"]
        self.patch_embed = nn.Conv2d(3, dim, VIT["patch_size"], VIT["patch_size"])
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, side * side + 1, dim))
        for i in range(VIT["depth"]):
            self.add_module(f"block_{i}", Block(dim, VIT["num_heads"]))
        self.norm = nn.LayerNorm(dim, eps=1e-6)

    def forward(self, x):
        """x (N, 3, H, W) -> the final norm of every token (N, 1 + patches, C).
        The position table is resized bicubically (a = -0.75) with DINO's
        scale factor (patches + 0.1) / side."""
        n = x.shape[0]
        dim, side = VIT["embed_dim"], VIT["pretrain_size"] // VIT["patch_size"]
        patches = self.patch_embed(x)
        ph, pw = patches.shape[-2:]
        pos = self.pos_embed[:, 1:]
        if (ph, pw) != (side, side):
            pos = resize_bicubic_torch(pos.reshape(1, side, side, dim), (ph, pw),
                                       scale=((ph + 0.1) / side, (pw + 0.1) / side)).reshape(1, ph * pw, dim)
        tokens = torch.cat([(self.cls_token + self.pos_embed[:, :1]).expand(n, 1, dim),
                            patches.flatten(2).transpose(1, 2) + pos], dim=1)
        for i in range(VIT["depth"]):
            tokens = getattr(self, f"block_{i}")(tokens)
        return self.norm(tokens)


class BackboneDino(nn.Module):
    def __init__(self, cfg: BackboneDinoCfg):
        super().__init__()
        if cfg.model != "dino_vitb8":
            raise ValueError(f"the reference has dino_vitb8 only, not {cfg.model!r}")
        dim = VIT["embed_dim"]
        self.resnet = ResNet()
        self.projections = nn.ModuleList(nn.Conv2d(c, cfg.d_out, 1) for c in (64, 256, 512, 1024))
        self.vit = ViT()
        self.global_mlp = nn.Sequential(nn.Linear(dim, dim), nn.ReLU(), nn.Linear(dim, cfg.d_out))
        self.local_mlp = nn.Sequential(nn.Linear(dim, dim), nn.ReLU(), nn.Linear(dim, cfg.d_out))

    def forward(self, image):
        """image (N, 3, H, W) -> (N, d_out, H, W)."""
        n, _, h, w = image.shape
        p = VIT["patch_size"]
        total = 0
        for proj, f in zip(self.projections, self.resnet(image)):
            total = total + F.interpolate(proj(f), size=(h, w), mode="bilinear", align_corners=True)
        tokens = self.vit(image)
        glob = self.global_mlp(tokens[:, 0])[:, :, None, None].expand(n, -1, h, w)
        local = self.local_mlp(tokens[:, 1:]).transpose(1, 2).reshape(n, -1, h // p, w // p)
        local = local.repeat_interleave(p, dim=2).repeat_interleave(p, dim=3)
        return total + local + glob


# ---- the epipolar transformer ------------------------------------------------------


def sines(values, octaves: int):
    """values (..., D) -> (..., D * octaves * 2): for each value, each octave
    k, sin(2 pi 2^k value) and sin(2 pi 2^k value + pi / 2)."""
    parts = []
    for i in range(values.shape[-1]):
        for k in range(octaves):
            f = 2 * math.pi * 2.0**k
            parts.append(torch.sin(values[..., i] * f))
            parts.append(torch.sin(values[..., i] * f + 0.5 * math.pi))
    return torch.stack(parts, dim=-1)


class SelfAttentionBlock(nn.Module):
    def __init__(self, d: int, heads: int, d_dot: int, d_mlp: int):
        super().__init__()
        self.heads, self.d_dot = heads, d_dot
        self.attn_norm = nn.LayerNorm(d)
        self.to_qkv = nn.Linear(d, 3 * heads * d_dot, bias=False)
        self.to_out = nn.Linear(heads * d_dot, d)
        self.ff_norm = nn.LayerNorm(d)
        self.ff_1 = nn.Linear(d, d_mlp)
        self.ff_2 = nn.Linear(d_mlp, d)

    def forward(self, x):
        """x (N, T, d)."""
        n, t, _ = x.shape
        h, e = self.heads, self.d_dot
        q, k, v = self.to_qkv(self.attn_norm(x)).chunk(3, dim=-1)
        q, k, v = (u.reshape(n, t, h, e).transpose(1, 2) for u in (q, k, v))
        a = torch.softmax(q @ k.transpose(-2, -1) * e**-0.5, dim=-1)
        x = x + self.to_out((a @ v).transpose(1, 2).reshape(n, t, h * e))
        return x + self.ff_2(F.gelu(self.ff_1(self.ff_norm(x))))


class ImageSelfAttention(nn.Module):
    def __init__(self, cfg: ImageSelfAttentionCfg, d_in: int, d_out: int):
        super().__init__()
        self.cfg = cfg
        self.positions = nn.Linear(2 * 2 * cfg.num_octaves, cfg.d_token)
        self.patch_embedder = nn.Conv2d(d_in, cfg.d_token, cfg.patch_size, cfg.patch_size)
        self.blocks = nn.ModuleList(SelfAttentionBlock(cfg.d_token, cfg.num_heads, cfg.d_dot, cfg.d_mlp)
                                    for _ in range(cfg.num_layers))
        self.resampler = nn.ConvTranspose2d(cfg.d_token, d_out, cfg.patch_size, cfg.patch_size)

    def forward(self, image):
        """image (N, d_in, H, W) -> (N, d_out, H, W)."""
        tokens = torch.relu(self.patch_embedder(image))
        n, c, nh, nw = tokens.shape
        xy = sample_image_grid((nh, nw), device=image.device)[0]  # (nh, nw, 2): x, y
        tokens = tokens + self.positions(sines(xy, self.cfg.num_octaves)).permute(2, 0, 1)[None]
        tokens = tokens.reshape(n, c, nh * nw).transpose(1, 2)
        for block in self.blocks:
            tokens = block(tokens)
        return self.resampler(tokens.transpose(1, 2).reshape(n, c, nh, nw))


class ConvFeedForward(nn.Module):
    def __init__(self, cfg: ImageSelfAttentionCfg, d: int, d_hidden: int):
        super().__init__()
        self.conv_1 = nn.Conv2d(d, d_hidden, 7, 1, 3)
        self.conv_2 = nn.Conv2d(d_hidden, d, 7, 1, 3)
        self.self_attention = ImageSelfAttention(cfg, d, d)

    def forward(self, x, shape):
        """x (n hl wl, 1, d) -> the same."""
        n, hl, wl = shape
        f = x[:, 0].reshape(n, hl, wl, -1).permute(0, 3, 1, 2)
        y = self.conv_2(F.gelu(self.conv_1(f))) + self.self_attention(f)
        return y.permute(0, 2, 3, 1).reshape(n * hl * wl, 1, -1)


class EpipolarLayer(nn.Module):
    def __init__(self, d: int, heads: int, d_dot: int, d_mlp: int, self_attention: ImageSelfAttentionCfg):
        super().__init__()
        self.heads, self.d_dot = heads, d_dot
        self.attn_norm = nn.LayerNorm(d)
        self.to_q = nn.Linear(d, heads * d_dot, bias=False)
        self.to_kv = nn.Linear(d, 2 * heads * d_dot, bias=False)
        self.to_out = nn.Linear(heads * d_dot, d)
        self.ff_norm = nn.LayerNorm(d)
        self.ff = ConvFeedForward(self_attention, d, d_mlp)

    def forward(self, x, z, shape):
        """x (N, 1, d) the ray's own token, z (N, S, d) its samples, the rays
        the grid `shape` (n, hl, wl)."""
        n, s, _ = z.shape
        h, e = self.heads, self.d_dot
        q = self.to_q(self.attn_norm(x)).reshape(n, 1, h, e).transpose(1, 2)
        k, v = self.to_kv(z).chunk(2, dim=-1)
        k = k.reshape(n, s, h, e).transpose(1, 2)
        v = v.reshape(n, s, h, e).transpose(1, 2)
        a = torch.softmax(q @ k.transpose(-2, -1) * e**-0.5, dim=-1)
        x = x + self.to_out((a @ v).transpose(1, 2).reshape(n, 1, h * e))
        return x + self.ff(self.ff_norm(x), shape)


class EpipolarTransformer(nn.Module):
    def __init__(self, cfg: EpipolarTransformerCfg, d: int):
        super().__init__()
        self.cfg = cfg
        self.downscaler = nn.Conv2d(d, d, cfg.downscale, cfg.downscale)
        self.depth_encoding = nn.Linear(2 * cfg.num_octaves, d)
        self.layers = nn.ModuleList(EpipolarLayer(d, cfg.num_heads, cfg.d_dot, cfg.d_mlp, cfg.self_attention)
                                    for _ in range(cfg.num_layers))
        self.upscaler = nn.ConvTranspose2d(d, d, cfg.downscale, cfg.downscale)
        self.refine_1 = nn.Conv2d(d, 2 * d, 7, 1, 3)
        self.refine_2 = nn.Conv2d(2 * d, d, 7, 1, 3)

    def encode_depth(self, rel):
        return self.depth_encoding(sines(rel[..., None], self.cfg.num_octaves))

    def sample(self, low, extrinsics, intrinsics, near, far):
        """low (b v, d, hl, wl) -> (x (b v r, d), z (b v r, S, d), valid (b, v, r)).
        The geometry in float64 (a far sample's rays are close to parallel:
        float32 rounding of its image point alone would scramble the high
        octaves of its depth's encoding); the sampled features in float32."""
        b, v = extrinsics.shape[:2]
        _, d, hl, wl = low.shape
        s = self.cfg.num_samples
        extr, intr, near, far = extrinsics.double(), intrinsics.double(), near.double(), far.double()
        xy = sample_image_grid((hl, wl), device=low.device, dtype=torch.float64)[0].reshape(-1, 2)
        maps = low.reshape(b, v, d, hl, wl)
        xs, zs, valids = [], [], []
        for i in range(v):
            j = 1 - i  # the other view
            origins, dirs = get_world_rays(xy, extr[:, i, None], intr[:, i, None])  # (b, r, 3)
            e_j, k_j = extr[:, j, None], intr[:, j, None]
            nr, fr = near[:, i, None].expand(b, xy.shape[0]), far[:, i, None].expand(b, xy.shape[0])
            start, end, valid = project_rays(origins, dirs, e_j, k_j, nr, fr)
            start = torch.where(valid[..., None], start, torch.zeros_like(start))
            end = torch.where(valid[..., None], end, torch.zeros_like(end))
            frac = (torch.arange(s, device=low.device, dtype=torch.float64) + 0.5) / s
            pts = start[:, :, None] + frac[None, None, :, None] * (end - start)[:, :, None]  # (b, r, s, 2)
            got = F.grid_sample(maps[:, j], (2 * pts - 1).float(), mode="bilinear", padding_mode="zeros",
                                align_corners=False)
            got = got.permute(0, 2, 3, 1) * valid[:, :, None, None]  # (b, r, s, d)
            depth = depth_along_ray(origins[:, :, None], dirs[:, :, None], pts, e_j[:, :, None], k_j[:, :, None])
            depth = torch.where(torch.isnan(depth), torch.full_like(depth, float("inf")), depth)
            lo, hi = near[:, i, None, None], far[:, i, None, None]
            depth = torch.clamp(depth, min=lo, max=hi)
            rel = (1.0 - (1.0 / depth - 1.0 / hi) / (1.0 / lo - 1.0 / hi)).float()
            zs.append(got + self.encode_depth(rel))
            xs.append(maps[:, i].flatten(2).transpose(1, 2))  # (b, r, d)
            valids.append(valid)
        x = torch.stack(xs, 1).reshape(-1, d)
        z = torch.stack(zs, 1).reshape(-1, s, d)
        return x, z, torch.stack(valids, 1)

    def attend(self, x, z, shape):
        x = x[:, None]
        for layer in self.layers:
            x = layer(x, z, shape)
        return x[:, 0]

    def upscale(self, x, shape):
        n, hl, wl = shape
        y = self.upscaler(x.reshape(n, hl, wl, -1).permute(0, 3, 1, 2))
        return y + self.refine_2(F.gelu(self.refine_1(y)))


class EncoderEpipolar(nn.Module):
    def __init__(self, cfg: EncoderEpipolarCfg = EncoderEpipolarCfg(), device="cuda"):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_feature
        self.backbone = BackboneDino(cfg.backbone)
        self.projection = nn.Linear(cfg.backbone.d_out, d)
        self.epipolar = EpipolarTransformer(cfg.epipolar_transformer, d)
        self.skip = nn.Conv2d(3, d, 7, 1, 3)
        self.depth_head = nn.Linear(d, 2 * cfg.num_monocular_samples)
        self.to_gaussians = nn.Linear(d, 2 + cfg.gaussian_adapter.d_in)
        self.to(device)
        self.eval()

    def features(self, image):
        """Stage 1: image (b v, 3, H, W) -> F (b v, H, W, d)."""
        return self.projection(torch.relu(self.backbone(image)).permute(0, 2, 3, 1))

    def head_input(self, x, image, shape):
        """Stage 4: the attended rays -> ReLU(F) (b v, H, W, d)."""
        y = self.epipolar.upscale(x, shape)
        return torch.relu(y + torch.relu(self.skip(image))).permute(0, 2, 3, 1)

    def depths(self, f, near, far):
        """Stage 5: ReLU(F) (b, v, H, W, d) -> (depths, densities, bucket indices)
        (b, v, H W, k), and the raw channels (b, v, H W, c)."""
        b, v, h, w, _ = f.shape
        n, k = self.cfg.num_monocular_samples, self.cfg.gaussians_per_pixel
        out = self.depth_head(f)
        pdf = torch.softmax(out[..., :n], dim=-1)
        offset = torch.sigmoid(out[..., n:])
        order = torch.sort(pdf, dim=-1, descending=True, stable=True).indices[..., :k]
        density = torch.gather(pdf, -1, order) / pdf.sum(-1, keepdim=True)
        rel = (order.to(pdf.dtype) + torch.gather(offset, -1, order)) / n
        nr, fr = near[:, :, None, None, None], far[:, :, None, None, None]
        depth = 1.0 / ((1.0 - rel) * (1.0 / nr - 1.0 / fr) + 1.0 / fr)
        raw = self.to_gaussians(f)
        flat = lambda t: t.reshape(b, v, h * w, t.shape[-1])  # noqa: E731
        return flat(depth), flat(density), flat(order), flat(raw)

    def gaussians(self, raw, depth, density, extrinsics, intrinsics, image_shape, global_step: int = 0) -> Gaussians:
        """The adapter for each (pixel, sample): raw (b, v, r, c), depth and
        density (b, v, r, k) -> Gaussians (b, v r k, ...)."""
        (h, w), (b, v, r, k) = image_shape, depth.shape
        cfg = self.cfg
        xy = sample_image_grid((h, w), device=raw.device)[0].reshape(1, 1, r, 2)
        coords = xy + (torch.sigmoid(raw[..., :2]) - 0.5) * torch.tensor([1.0 / w, 1.0 / h], device=raw.device)
        coords = coords[:, :, :, None].expand(b, v, r, k, 2).reshape(b, v, r * k, 2)
        channels = raw[:, :, :, None, 2:].expand(b, v, r, k, raw.shape[-1] - 2).reshape(b, v, r * k, -1)
        opacity = map_pdf_to_opacity(density, cfg.opacity_mapping, global_step) / cfg.gaussians_per_pixel
        out = adapt_gaussians(cfg.gaussian_adapter, extrinsics, intrinsics, coords, depth.reshape(b, v, r * k),
                              opacity.reshape(b, v, r * k), channels, (h, w))
        g = v * r * k
        return Gaussians(out["means"].reshape(b, g, 3), out["covariances"].reshape(b, g, 3, 3),
                         out["harmonics"].reshape(b, g, 3, cfg.gaussian_adapter.d_sh), out["opacities"].reshape(b, g))

    def forward(self, images, intrinsics, extrinsics, near, far, global_step: int = 0, return_picks: bool = False):
        """images (b, v, H, W, 3) in [0, 1] -> Gaussians (b, v H W 3, ...); with
        `return_picks`, (Gaussians, the picked buckets (b, v, H W, 3), the
        pdf's 4 largest probabilities, descending (b, v, H W, 4))."""
        b, v, h, w, _ = images.shape
        down = self.cfg.epipolar_transformer.downscale
        image = images.permute(0, 1, 4, 2, 3).reshape(b * v, 3, h, w)
        f = self.features(image)
        low = self.epipolar.downscaler(f.permute(0, 3, 1, 2))
        x, z, _ = self.epipolar.sample(low, extrinsics, intrinsics, near, far)
        x = self.epipolar.attend(x, z, (b * v, h // down, w // down))
        f = self.head_input(x, image, (b * v, h // down, w // down)).reshape(b, v, h, w, -1)
        depth, density, order, raw = self.depths(f, near, far)
        g = self.gaussians(raw, depth, density, extrinsics, intrinsics, (h, w), global_step)
        if not return_picks:
            return g
        n = self.cfg.num_monocular_samples
        pdf = torch.softmax(self.depth_head(f)[..., :n], dim=-1).reshape(b, v, h * w, n)
        top = torch.sort(pdf, dim=-1, descending=True).values[..., : self.cfg.gaussians_per_pixel + 1]
        return g, order, top
