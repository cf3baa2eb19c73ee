"""The frozen operation counts against values worked by hand."""

import pytest

from gamebench import counts, run

TINY = dict(img_feat_dim=4, img_h_dim=3, sender_out_dim=2, rec_w_dim=2,
            rec_hidden=2, wv_dim=5, baseline_hid_dim=7, num_classes=6,
            max_exchange=2, batch_size=1, visual_attn=False,
            attn_extra_context=False, feature_shape=[4])


def test_kernel_bound_at_the_canonical_width():
    cfg = run.load_config("adaptive")["cfg"]
    w = counts.kernel_work(cfg, 64)
    assert w["bound_s"] * 1e3 == pytest.approx(0.001355669014925373,
                                               rel=1e-12)
    assert w["bound_by"] == "operations"
    assert w["flops"] == 90829824


def test_forward_flops_by_hand():
    # once: 2*D*V*R + 2*W*H + 2*B*F*H = 120 + 12 + 24 = 156
    # turn 0: binary 12, GRU 2*(2+2)*6 = 48, heads 2*2*5 = 20,
    # y 4*6*2 = 48, softmax.desc 2*6*5 = 60, w_d 20, w 8 -> 216
    # turn 1: + code layer 12 -> 228
    assert counts.forward_flops(TINY, 1, 2, train=False) == 156 + 216 + 228
    # baselines a turn: 2*(3+2)*7 + 14 + 2*(2+2)*7 + 14 = 154
    assert counts.forward_flops(TINY, 1, 2, train=True) == 600 + 2 * 154
    assert counts.train_flops(TINY) == 3 * 908


def test_attention_counts_each_turn():
    cfg = run.load_config("adaptive_attention")["cfg"]
    plain = dict(cfg, visual_attn=False, feature_shape=[512])
    assert counts.train_flops(cfg) > 4 * counts.train_flops(plain)


class _Event:
    """A profiler event as ``trace.Trace`` reads it."""

    def __init__(self, name, start, dur, on_card):
        self._name, self._start, self._dur = name, start, dur
        self.on_card = on_card

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur

    def device_type(self):
        from torch.autograd import DeviceType
        return DeviceType.CUDA if self.on_card else DeviceType.CPU

    def is_user_annotation(self):
        return False


def test_eval_roofline_counts_a_launch_read_past_the_window():
    """The card's clock, mapped onto the host's, drifts: the last
    request's launch can read as starting after the window closed. It is
    still the window's launch, and the roofline still reads."""
    from gamebench import trace
    kernel = "void (anonymous namespace)::fused_exchange_kernel<false>(Args)"
    events = [_Event(trace.WINDOW, 1_000, 9_000, False),
              _Event("gamebench.request", 1_100, 3_000, False),
              _Event("gamebench.request", 5_000, 4_900, False),
              _Event(kernel, 2_000, 500, True),
              _Event("Memcpy DtoH (Device -> Pinned)", 2_600, 100, True),
              _Event(kernel, 10_050, 700, True)]
    tr = trace.Trace(events)
    assert tr.kernel_times("fused_exchange_kernel<false>") == [
        pytest.approx(5e-7), pytest.approx(7e-7)]
    cfg = run.load_config("adaptive")["cfg"]
    read = run.metric_reader("eval_kernel_roofline")
    ctx = {"kind": "serve", "trace": tr, "cfg": cfg, "batches": [100, 100],
           "n_steps": [4, 6]}
    bound = sum(counts.kernel_work(cfg, 100, turns=n)["bound_s"]
                for n in (4, 6))
    assert read(ctx) == pytest.approx(100.0 * bound / 1.2e-6, rel=1e-12)
    # A launch missing from the trace leaves the requests unpaired.
    assert read({**ctx, "batches": [100, 100, 100],
                 "n_steps": [4, 6, 5]}) is None
