"""Training cells: the port's chunked driver, ``game/driver.py:run_fast``,
the loop that ``train.run`` hands a game to, with the traffic file's
cadences (log windows, dev sweeps, checkpoints).

Set-up builds the agents once, with the benchmark's weights, and drives
them through the driver from step 0: the checked steps (one call for step
0, a log step and a dev sweep; one for the next ``checked_steps - 1``:
two eager steps, the capture of the step's CUDA graph, then replays),
then a warm-up call to the second period boundary, which crosses every
cadence. The window is one more call of the same agents and optimizer
state: a fixed amount of work, the whole periods nearest to ``--seconds``
at the configuration's ``nominal_steps_per_s``, so that it ends on a
period boundary, a log step. Past the window the same object takes the
checked steps again from the state the window left. Both stretches are
held to the reference: the first from the benchmark's weights, the second
from the window's weights and RMSprop state.
"""

import time

from gamebench import compare, program
from gamebench.reference.train import follow, follow_branches


def _extra(cell: str, traffic: dict, seed: int, workdir: str) -> dict:
    return {**traffic["flags"], "random_seed": seed % 2 ** 31,
            "log_path": workdir, "experiment_name": cell,
            "max_epoch": traffic["max_epoch"]}


class Entry:
    def __init__(self, cell, config, traffic, seed, device, workdir):
        from multimodalgame_tpu_torch.game.train import (init_opt_states,
                                                         make_eval_exchange)
        from multimodalgame_tpu_torch.utils.logging import VisdomLogger
        self.cell, self.cfg, self.traffic = cell, config["cfg"], traffic
        self.seed, self.device = seed, device
        self.nominal = config["nominal_steps_per_s"]
        self.flags = program.make_flags(config,
                                        _extra(cell, traffic, seed, workdir))
        self.prog_seed = self.flags.random_seed + 1   # the driver's Philox
        self.log = program.LogRecorder(self.flags.log_file)
        self.logger = VisdomLogger(enabled=False)
        self.modules = program.agents(self.flags, config["weights"], device)
        self.opt_states = init_opt_states(self.modules.cfg, self.modules)
        self.eval_exchange = make_eval_exchange(self.modules, use_kernel=True)
        sets = config["sets"]
        self.desc = program.description_pack(sets["desc"])
        self.train_ds = program.device_set(sets["train"], device)
        self.dev_ds = program.device_set(sets["dev"], device)
        self.step, self.best = 0, 0.0

    def drive(self, steps: int) -> None:
        from multimodalgame_tpu_torch.game.driver import run_fast
        out = run_fast(self.flags, self.modules, self.opt_states, self.desc,
                       self.desc, self.log, self.logger, self.eval_exchange,
                       step=self.step, best_dev_acc=self.best,
                       max_steps=self.step + steps, train_ds=self.train_ds,
                       dev_ds=self.dev_ds)
        self.step, self.best = int(out["step"]), float(out["best_dev_acc"])

    def setup(self) -> None:
        self.got = self.checked_steps()
        self.warm()

    def checked_steps(self) -> dict:
        """From the step the program stands at (a log step): that step
        alone, then the other checked steps, keeping what the program
        shows of them (its log, its optimizer state, its weights) and the
        state it started from. The first step's log window dumps every
        row's conversation, not the traffic's few: the bits the reference
        takes."""
        weights = {k: p.detach().clone()
                   for k, p in self.modules.named_parameters()}
        nu = program.rms_state(self.modules, self.opt_states)
        got = {"start": self.step, "weights": weights, "nu": nu}
        samples = self.flags.exchange_samples
        self.flags.exchange_samples = self.flags.batch_size
        first = len(self.log.lines)
        self.drive(1)
        self.flags.exchange_samples = samples
        got.update(
            grad_norms=program.nu_norms(self.modules, self.opt_states, nu),
            dev_acc=self.log.value("Development Accuracy: "),
            losses={k: self.log.value(m) for k, m in LOSS_LINES},
            bits=program.train_dump_bits(self.log.lines[first:],
                                         self.flags.batch_size, self.device))
        self.drive(self.traffic["checked_steps"] - 1)
        got["change_norms"] = {
            k: float((p.detach() - weights[k]).double().norm())
            for k, p in self.modules.named_parameters()}
        return got

    def warm(self) -> None:
        """The steps to the second period boundary, which cross every
        cadence."""
        period = self.traffic["period"]
        self.drive((self.step // period + 2) * period - self.step)
        program.sync(self.device)

    def window(self, seconds: float) -> dict:
        """One driver call of the whole periods nearest to ``seconds`` at
        the nominal rate."""
        period = self.traffic["period"]
        self.updates = period * max(1, round(self.nominal * seconds
                                             / period))
        t0 = time.perf_counter()
        self.drive(self.updates)
        elapsed = time.perf_counter() - t0
        return {"train_steps_per_s": self.updates / elapsed,
                "attempted": self.updates}

    def traced_window(self, seconds: float, tracer) -> dict:
        """One driver call, traced from the log line of its second period
        boundary to the one ``trace_periods`` periods later, and run one
        period past it: the steady stretch of a call, its dev sweeps and
        checkpoints in it, the call's own warm-up outside it."""
        period = self.traffic["period"]
        first = (self.step // period + 2) * period
        last = first + self.traffic["trace_periods"] * period
        marks = {}

        def watch(line):
            if not line.startswith("Epoch: ") or " Step: " not in line:
                return
            step = int(line.split(" Step: ")[1].split()[0])
            if step == first and not tracer.running and not marks:
                tracer.start()
                marks["first"] = step
            elif step == last and tracer.running:
                tracer.stop()
                marks["last"] = step
        self.log.watch = watch
        try:
            self.drive(last + period - self.step)
        finally:
            self.log.watch = None
            if tracer.running:
                tracer.stop()
        if "last" not in marks:
            raise RuntimeError("the driver's log never reached the traced "
                               f"steps {first} and {last}")
        self.updates = marks["last"] - marks["first"]
        return {"attempted": self.updates}

    def after_window(self) -> None:
        """The checked steps again, from the step, weights and RMSprop
        state that the window left."""
        self.got_after = self.checked_steps()

    def metric_context(self) -> dict:
        return {"kind": "train", "updates": self.updates}

    def release(self) -> None:
        for name in ("modules", "opt_states", "eval_exchange", "train_ds",
                     "dev_ds"):
            setattr(self, name, None)

    def follow(self, sets, weights, start=0, nu=None, **kw):
        """The reference's readings of the checked steps from ``start``
        (see ``reference/train.py``)."""
        return follow(self.cfg, sets, weights, self.prog_seed,
                      self.traffic["checked_steps"], start=start, nu=nu,
                      **kw)

    def numbers(self, sets, weights, got, after) -> dict:
        """The compared numbers of ``got`` (the program's readings, or
        the control's or a fault's in its place) against the reference
        run on its first step's bits, named ``after_*`` past the window;
        the worst leaf's change gap and the reference's ties go to
        ``info``, shown and not
        compared. The stretch before the window starts from the
        benchmark's ``weights``; the one after, from the state the
        window left."""
        kw = ({"start": got["start"], "nu": got["nu"]} if after else {})
        ref = follow_branches(self.cfg, sets,
                              got["weights"] if after else weights,
                              self.prog_seed, self.traffic["checked_steps"],
                              forced=got["bits"], **kw)
        pre = "after_" if after else ""
        self.info[pre + "change_gap_worst_leaf"] = compare.worst_change(
            got, ref)
        self.info[pre + "ties"] = len(ref[0]["ties"])
        return {pre + k: v
                for k, v in compare.train_numbers(got, ref).items()}

    def check(self, sets, weights) -> dict:
        self.info = {}
        return {**self.numbers(sets, weights, self.got, False),
                **self.numbers(sets, weights, self.got_after, True)}

    def control_readings(self, sets, weights) -> dict:
        """The control (the reference with its products in TF32) and each
        planted fault, in the program's place over both stretches: from
        the benchmark's weights, and from the state the window left."""
        out = {}
        for side, kw in [("control_tf32", {"prec": "tf32"})] + [
                (f, {"fault": f}) for f in FAULTS]:
            self.info = {}
            start = {k: self.got_after[k] for k in ("start", "weights", "nu")}
            before = self.follow(sets, weights, **kw)
            after = {**self.follow(sets, start["weights"],
                                   start=start["start"], nu=start["nu"],
                                   **kw), **start}
            out[side] = {**self.numbers(sets, weights, before, False),
                         **self.numbers(sets, weights, after, True),
                         **self.info}
        return out


# The faults planted in the reference in the program's place: half of each
# batch left out, one message bit altered where it is drawn, the state
# left unchanged.
FAULTS = ("half", "flip", "frozen")

# The driver's log lines of a step's losses, by the reference's names.
LOSS_LINES = (("loss_sen", "Loss Sender: "),
              ("nll_loss", "Loss Receiver (Y): "),
              ("loss_binary_rec", "Loss Receiver (Z): "),
              ("loss_binary_s", "Loss Receiver (S): "),
              ("loss_bas_sen", "Loss Baseline (S): "),
              ("loss_bas_rec", "Loss Baseline (R): "))
