"""Models: embeddings, readouts, the MPQE encoder and the GQE baselines."""


def is_mpqe(cfg) -> bool:
    """True for an ``MPQEConfig``, False for a ``GQEConfig``; any other
    config raises ``TypeError``."""
    from mpqe_tpu_torch.models import gqe, mpqe

    if isinstance(cfg, mpqe.MPQEConfig):
        return True
    if isinstance(cfg, gqe.GQEConfig):
        return False
    raise TypeError(f"no model for {type(cfg).__name__}")


def build_model(cfg, device=None):
    """The uninitialized module of ``cfg``'s model (``MPQE`` or ``GQE``)
    on ``device``, e.g. to load a state dict into."""
    from mpqe_tpu_torch.models import gqe, mpqe

    return (mpqe.MPQE if is_mpqe(cfg) else gqe.GQE)(cfg, device=device)
