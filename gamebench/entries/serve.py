"""Serving cells: ``serve.Predictor.predict`` called in a closed loop by
one client, as a library caller waits on each answer.

The requests are ``serve.main``'s (serve.py:202-208): the traffic's set
(the dev set the benchmark makes from the seed) read in order in batches
of the traffic's ``batch_size`` (a number, or the name of the
configuration's flag that gives it), the shorter last batch kept. The
client sends them in order, round the set. Set-up captures each batch
size's CUDA graph. The latency of a request is the host's clock from the
call to its return. The last answer of each request is kept; the check
judges a sample of them drawn from the seed, with the longest
conversation and every batch of another size among them.
"""

import random
import time

import numpy as np
import torch

from gamebench import compare, data, program, trace
from gamebench.reference.game import eval_answers, judge_answers


class Entry:
    def __init__(self, cell, config, traffic, seed, device, workdir):
        from multimodalgame_tpu_torch.game.config import GameConfig
        from multimodalgame_tpu_torch.serve import Predictor
        self.cfg, self.traffic, self.device = config["cfg"], traffic, device
        flags = program.make_flags(config, {"log_path": workdir,
                                            "experiment_name": cell})
        modules = program.agents(flags, config["weights"], device)
        self.predictor = Predictor(GameConfig.from_flags(flags), modules,
                                   program.description_pack(
                                       config["sets"]["desc"]),
                                   device=device)
        batch = traffic["batch_size"]
        batch = int(self.cfg[batch] if isinstance(batch, str) else batch)
        self.pool = data.consecutive_batches(config["sets"][traffic["set"]],
                                             batch)
        self.sizes = [f.shape[0] for f, _ in self.pool]
        self.seed = seed
        self.kept = {}

    def predict(self, slot: int) -> dict:
        feats, ctx = self.pool[slot]
        return self.predictor.predict(feats, data_context=ctx)

    def setup(self) -> None:
        for size in sorted(set(self.sizes)):
            for _ in range(self.traffic["warmup_calls"]):
                self.predict(self.sizes.index(size))
        program.sync(self.device)

    def loop(self, until=None, mark=False):
        lat, served, n_steps = [], [], []
        i = 0
        while until is None or time.perf_counter() < until:
            slot = i % len(self.pool)
            t0 = time.perf_counter()
            if mark:
                with trace.request_annotation():
                    out = self.predict(slot)
            else:
                out = self.predict(slot)
            lat.append(time.perf_counter() - t0)
            served.append(self.sizes[slot])
            n_steps.append(out["n_steps"])
            self.kept[slot] = out
            i += 1
        return lat, served, n_steps

    def window(self, seconds: float) -> dict:
        lat, _, _ = self.loop(until=time.perf_counter() + seconds)
        return {"serve_p95_ms": 1e3 * float(np.percentile(lat, 95)),
                "attempted": len(lat)}

    def traced_window(self, seconds: float, tracer) -> dict:
        """The same loop, each request marked, traced for the traffic's
        ``trace_seconds`` (at most ``seconds``)."""
        seconds = min(seconds, self.traffic["trace_seconds"])
        with trace.traced(tracer):
            _, self.served, self.n_steps = self.loop(
                until=time.perf_counter() + seconds, mark=True)
        return {"attempted": len(self.served)}

    def after_window(self) -> None:
        """Nothing: the window's own answers are judged."""

    def metric_context(self) -> dict:
        return {"kind": "serve", "batches": self.served,
                "n_steps": self.n_steps}

    def release(self) -> None:
        self.predictor = None

    def sample(self) -> list:
        """The served requests the check judges: ``sample`` of them drawn
        from the seed, the one whose conversation ran the most turns, and
        each of a batch size that is not the most common."""
        rng = random.Random(self.seed)
        served = sorted(self.kept)
        picked = set(rng.sample(served, min(len(served),
                                            self.traffic["sample"])))
        if served:
            picked.add(max(served,
                           key=lambda i: int(self.kept[i]["n_steps"])))
        common = max(set(self.sizes), key=self.sizes.count)
        picked |= {i for i in served if self.sizes[i] != common}
        return sorted(picked)

    def judged(self, weights, desc, answers) -> list:
        out = []
        for slot, served in answers.items():
            feats, ctx = (None if a is None else
                          torch.as_tensor(a, device=self.device)
                          for a in self.pool[slot])
            out.append(judge_answers(weights, self.cfg, feats, desc, served,
                                     ctx=ctx))
        return out

    def check(self, sets, weights) -> dict:
        """The compared numbers of the sampled answers (``reference/
        game.py:judge_answers``); none where no request was served."""
        out = self.judged(weights, sets["desc"],
                          {s: self.kept[s] for s in self.sample()})
        return compare.serve_numbers(out) if out else {}

    def control_readings(self, sets, weights) -> dict:
        """The control: the reference's own answers in TF32, in the
        program's place, on the same sampled requests."""
        answers = {}
        for slot in self.sample():
            feats, ctx = (None if a is None else
                          torch.as_tensor(a, device=self.device)
                          for a in self.pool[slot])
            answers[slot] = {k: (v.cpu().numpy() if torch.is_tensor(v)
                                 else v)
                             for k, v in eval_answers(weights, self.cfg, feats,
                                                      sets["desc"], ctx,
                                                      prec="tf32").items()}
        return {"control_tf32": compare.serve_numbers(
            self.judged(weights, sets["desc"], answers))}
