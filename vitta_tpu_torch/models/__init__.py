"""Model zoo of the port: TANet (ResNet-50+TAM), Video Swin, VideoMAE
ViT-B, R(2+1)D-18, I3D-ResNet and Inception-I3D."""

from vitta_tpu_torch.models.resnet import COMPUTE_DTYPES
from vitta_tpu_torch.models.swin import Recognizer3D
from vitta_tpu_torch.models.tanet import TANet


def get_model(cfg, attn_route=None):
    """Model-zoo dispatch (reference corpus/basics.py:1447-1493).
    ``attn_route`` chooses Video Swin's attention route ("packed", "proj",
    "ln_proj" or "heads", ``ops/dispatch.py:ATTN_ROUTES``; None reads the
    flags of ops/dispatch.py).  The norm layers record the statistic types
    of ``cfg.tta.tap_stat_types()``: the configured ``stat_type`` list, or
    the ``cossim`` tap under ``stat_reg="cossim"``.

    ``cfg.model.compute_dtype`` is "float32" or "bfloat16" (any other value
    raises).  TANet is built at it.  Video Swin is built at float32 under
    either, as vitta_tpu/models/__init__.py:14-23 builds it: that dispatch
    hands Swin no dtype.  The other models of the zoo (``i3d_resnet{depth}``,
    ``r2plus1d``, ``i3d_incep``, ``videomae``) take the class count alone,
    as vitta_tpu/models/__init__.py:24-35 builds them: float32 and the
    default ``("spatiotemp",)`` taps whatever the configuration says."""
    arch = cfg.model.arch
    if cfg.model.compute_dtype not in COMPUTE_DTYPES:
        raise NotImplementedError(
            f"compute_dtype={cfg.model.compute_dtype!r}: the port runs "
            "float32 or bfloat16")
    if arch == "tanet":
        return TANet(num_classes=cfg.model.num_classes,
                     clip_length=cfg.data.clip_length,
                     dropout=cfg.model.dropout,
                     stat_types=cfg.tta.tap_stat_types(),
                     dtype=cfg.model.compute_dtype)
    if arch == "videoswintransformer":
        return Recognizer3D(num_classes=cfg.model.num_classes,
                            patch_size=cfg.model.patch_size,
                            window_size=cfg.model.window_size,
                            embed_dim=cfg.model.embed_dim,
                            depths=cfg.model.depths,
                            num_heads=cfg.model.num_heads,
                            drop_path_rate=cfg.model.drop_path_rate,
                            stat_types=cfg.tta.tap_stat_types(),
                            attn_route=attn_route)
    if arch.startswith("i3d_resnet"):
        from vitta_tpu_torch.models.i3d import I3DResNet
        return I3DResNet(num_classes=cfg.model.num_classes,
                         depth=int(arch.replace("i3d_resnet", "")))
    if arch == "r2plus1d":
        from vitta_tpu_torch.models.r2plus1d import R2Plus1D
        return R2Plus1D(num_classes=cfg.model.num_classes)
    if arch == "i3d_incep":
        from vitta_tpu_torch.models.i3d_incep import InceptionI3d
        return InceptionI3d(num_classes=cfg.model.num_classes)
    if arch == "videomae":
        from vitta_tpu_torch.models.videomae import VideoMAE
        return VideoMAE(num_classes=cfg.model.num_classes)
    raise NotImplementedError(f"arch={arch}")
