"""Model zoo of the port: TANet (ResNet-50+TAM) so far."""

from vitta_tpu_torch.models.tanet import TANet


def get_model(cfg):
    """Model-zoo dispatch (reference corpus/basics.py:1447-1493)."""
    arch = cfg.model.arch
    if cfg.model.compute_dtype != "float32":
        raise NotImplementedError(
            f"compute_dtype={cfg.model.compute_dtype!r}: the port runs float32")
    if arch == "tanet":
        return TANet(num_classes=cfg.model.num_classes,
                     clip_length=cfg.data.clip_length,
                     dropout=cfg.model.dropout,
                     stat_types=cfg.tta.tap_stat_types())
    raise NotImplementedError(f"arch={arch} is not ported yet")
