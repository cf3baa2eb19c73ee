"""The inputs of a run, made from its seed on the card.

The sets follow data/synthetic.py's shapes (frozen here): each class has a
prototype, and an example is its class's prototype plus 0.3 Gaussian
noise; pooled features (``avgpool_512``) are taken in absolute value, as
ReLU outputs are. With visual attention an example is a ``(512, 8, 8)``
map (``layer4_2``) and a 1,000-wide ``fc`` context, each its prototype
plus noise. A class's description is a Gaussian vector of ``wv_dim``
(standing in for its GloVe CBOW row). Every draw comes from one
``torch.Generator`` on the card, in a few large calls.
"""

from typing import Dict

import torch


def make_sets(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """``desc`` (D, wv), and for ``train`` and ``dev``: ``feats`` (pooled
    features, or maps under visual attention), ``ctx`` (the ``fc``
    context, or None) and ``labels`` (int64), on ``device``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    D = cfg["num_classes"]
    shape = tuple(cfg["feature_shape"])

    def randn(*size):
        return torch.randn(size, generator=gen, device=device)

    out = {"desc": randn(D, cfg["wv_dim"])}
    proto = randn(D, *shape)
    proto_ctx = randn(D, cfg["attn_context_dim"]) if cfg["visual_attn"] \
        else None
    for part in ("train", "dev"):
        n = cfg[part + "_per_class"]
        labels = torch.arange(D, device=device).repeat_interleave(n)
        feats = proto[labels] + 0.3 * randn(D * n, *shape)
        if not cfg["visual_attn"]:
            feats = feats.abs()
        ctx = None
        if proto_ctx is not None and cfg["attn_extra_context"]:
            ctx = proto_ctx[labels] + 0.3 * randn(D * n,
                                                  cfg["attn_context_dim"])
        out[part] = {"feats": feats.contiguous(), "ctx": ctx,
                     "labels": labels}
    return out


def consecutive_batches(part: dict, batch: int):
    """A set's rows in order, cut into batches of ``batch`` with the
    shorter last batch kept (``serve.main``'s reading of a dev file:
    ``load_hdf5(..., shuffle=False, truncate_final_batch=True)``).
    Returns each batch's features and ``fc`` context (or None) on the
    host as float32 numpy arrays."""
    feats = part["feats"].cpu().numpy()
    ctx = None if part["ctx"] is None else part["ctx"].cpu().numpy()
    return [(feats[a:a + batch], None if ctx is None else ctx[a:a + batch])
            for a in range(0, feats.shape[0], batch)]
