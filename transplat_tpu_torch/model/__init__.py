from .types import Gaussians

__all__ = ["Gaussians", "build_encoder"]


def build_encoder(cfg, device="cuda"):
    """The encoder a configuration describes: pixelSplat's EncoderEpipolar for
    an EncoderEpipolarCfg, else EncoderTranSplat (an EncoderCfg)."""
    from .encoder_epipolar import EncoderEpipolar, EncoderEpipolarCfg

    if isinstance(cfg, EncoderEpipolarCfg):
        return EncoderEpipolar(cfg, device=device)
    from .encoder import EncoderTranSplat

    return EncoderTranSplat(cfg, device=device)
