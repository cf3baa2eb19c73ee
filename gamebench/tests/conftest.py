import pytest

# A game small enough for the CPU: every width cut, as the cells never are.
TINY = dict(img_feat_dim=24, img_h_dim=12, sender_out_dim=8, rec_w_dim=8,
            rec_hidden=12, wv_dim=16, baseline_hid_dim=12, max_exchange=3,
            batch_size=8, batch_size_dev=8, num_classes=6,
            train_per_class=8, dev_per_class=4, attn_dim=8,
            attn_context_dim=10)


def tiny_sizes(cell: str) -> dict:
    shape = [24, 2, 2] if "attention" in cell else [24]
    return dict(TINY, feature_shape=shape)


@pytest.fixture
def card():
    """The CUDA card, or a skip where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
