"""Model zoo of the port: TANet (ResNet-50+TAM) and Video Swin so far."""

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
    hands Swin no dtype."""
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
    raise NotImplementedError(f"arch={arch} is not ported yet")
