"""Training steps back to back: ``Pipeline.train_step`` on batches of
``batch`` seeded uint8 images and captions (``<start>``, words drawn from the
vocabulary, ``<end>``, padded with 0 to ``max_seq_len``; lengths uniform in
``caption_lengths``), cycling over a pool of ``pool`` distinct batches. The
pipeline keeps its checkpoint directory in a temporary directory and saves
nothing.

Set-up builds the training pipeline and drives it through its first
``CHECK_STEPS`` steps on the pool's first batches: those are the steps the
reference follows (their losses, the first gradient as the optimizer holds
it after one step, the parameters after the last), and the window goes on
from there with the same pipeline. Once the window has closed, one more
step goes through the window's own call on the pool's next batch; the
state before it and the change it made are kept, and the reference takes
the same step from that state (``judge.window_numbers``).

Traffic keys: ``batch``, ``pool``, ``caption_lengths``, ``trace_calls``."""

from __future__ import annotations

import tempfile

import numpy as np
import torch

from .. import counts, harness, inputs, judge, profiling
from ..reference import train as ref_train

CHECK_STEPS = 3


def _norm(a) -> float:
    a = np.asarray(a, np.float64)
    return float(np.sqrt((a * a).sum()))


class Run:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device: torch.device):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.vocab, self.max_len = cfg["vocab_size"], cfg["max_seq_len"]

    def make_state(self) -> dict:
        """The run's weights on the device; a host copy is kept for the
        reference."""
        state = inputs.make_weights(self.cfg, self.vocab, self.seed, self.device)
        self.state = {k: v.cpu() for k, v in state.items()}
        return state

    def make_pool(self) -> None:
        t = self.traffic
        self.pool = []
        for k in range(t["pool"]):
            rng = np.random.default_rng(inputs.subseed(self.seed, 2000 + k))
            self.pool.append((inputs.images(t["batch"], self.cfg["image_input_size"],
                                            inputs.subseed(self.seed, k), self.device),
                              inputs.captions(t["batch"], self.max_len, self.vocab,
                                              tuple(t["caption_lengths"]), rng)))

    # ---------------------------------------------------------------- set-up
    def setup(self) -> None:
        from fpn_mt_image_captioning_torch.train.pipeline import Pipeline

        dev = self.device
        self.initial = inputs.flax_tree(self.make_state(), self.cfg, self.vocab)
        self.tmp = tempfile.TemporaryDirectory()
        self.pipe = Pipeline(harness.tokenizer(self.vocab), self.max_len,
                             harness.program_config(self.cfg, seed=self.seed,
                                                    batch_size=self.traffic["batch"]),
                             self.initial, device=dev, checkpoint_path=self.tmp.name)
        self.make_pool()
        losses, grad = [], None
        for k in range(CHECK_STEPS):
            losses.append(self.pipe.train_step(*self.pool[k]))
            if k == 0:
                m = self.pipe.state_tree()["opt_state"]["1"]["m"]
                grad = {p: _norm(a) / (1 - ref_train.B1) for p, a in inputs.leaves(m)}
        params = dict(inputs.leaves(self.pipe.state_tree()["params"]))
        change = {p: _norm(np.asarray(params[p], np.float64) - a)
                  for p, a in inputs.leaves(self.initial["params"])}
        self.program = {"losses": losses, "grad": grad, "change": change}
        self.steps = CHECK_STEPS
        harness.sync(dev)

    # ---------------------------------------------------------------- window
    def window(self, seconds: float) -> dict:
        pool, pipe = self.pool, self.pipe
        losses = []
        start = harness.now()
        deadline, end = start + seconds, start
        while harness.now() < deadline:
            losses.append(pipe.train_step(*pool[self.steps % len(pool)]))
            self.steps += 1
            end = harness.now()
        self.window_s, self.window_steps = end - start, len(losses)
        return {"attempted": len(losses), "failed": sum(not np.isfinite(x) for x in losses),
                "metrics": {"train_images_per_s":
                            len(losses) * self.traffic["batch"] / self.window_s}}

    def device_metrics(self, names) -> dict:
        """No end-to-end metric of a training cell comes from a device trace."""
        return {}

    # ---------------------------------------------------------------- trace
    def trace(self) -> dict:
        t = self.traffic
        calls = t["trace_calls"]

        def steps():
            for _ in range(calls):
                self.pipe.train_step(*self.pool[self.steps % len(self.pool)])
                self.steps += 1

        prof = profiling.profile_calls(steps)
        model = inputs.reference_model(self.cfg, self.vocab)
        self.measured = {
            "window_s": self.window_s, "steps": self.window_steps, "batch": t["batch"],
            "step_flops": counts.train_flops(model, t["batch"], self.cfg["image_input_size"],
                                             self.max_len),
            "train_busy_s": prof["busy_s"], "trace_calls": calls,
        }
        return {"busy_s": prof["busy_s"], "window_s": prof["wall_s"],
                "breakdown": {"device_ops": prof["device_ops"], "idle_gaps": prof["idle_gaps"]}}

    # ---------------------------------------------------------------- check
    def release(self) -> None:
        """The step after the window, kept for the check; then the captioner
        is freed."""
        before = self.pipe.state_tree()
        batch = self.pool[self.steps % len(self.pool)]
        loss = self.pipe.train_step(*batch)
        self.steps += 1
        after = dict(inputs.leaves(self.pipe.state_tree()["params"]))
        self.after_window = {"state": before, "batch": batch, "loss": loss,
                             "change": {p: _norm(np.asarray(after[p], np.float64) - a)
                                        for p, a in inputs.leaves(before["params"])}}
        del self.pipe
        self.tmp.cleanup()
        harness.free(self.device)

    def reference_readings(self, numerics=None, rows: int | None = None) -> dict:
        """Losses, first gradient and change norms of the reference's first
        ``CHECK_STEPS`` steps on the pool's batches (their first ``rows``
        rows where given: the fault of a step that leaves half the batch out)."""
        dev = self.device
        model = harness.reference(self.cfg, self.vocab, self.state, dev, numerics)
        start = {k: v.detach().clone() for k, v in model.named_parameters()}
        paths = inputs.flax_paths(self.cfg, self.vocab)
        names = [k for k, _ in model.named_parameters()]
        grad = {}

        def on_step(i, _model, _opt, grads):
            if i == 0:
                grad.update({paths[k]: float(g.double().norm()) for k, g in zip(names, grads)})

        batches = [(torch.as_tensor(img[:rows], device=dev), torch.as_tensor(cap[:rows], device=dev))
                   for img, cap in self.pool[:CHECK_STEPS]]
        losses = ref_train.train_steps(model, batches, seed=self.seed,
                                       dropout=self.cfg["dropout_rate"], d_lr=self.cfg["dff"],
                                       warmup=self.cfg["warm_up_steps"], on_step=on_step)
        change = {paths[k]: float((p.detach() - start[k]).double().norm())
                  for k, p in model.named_parameters()}
        return {"losses": losses, "grad": grad, "change": change}

    def window_reference(self, numerics=None, rows: int | None = None) -> dict:
        """Loss, gradient and change norms of the reference's step from the
        captioner's state before the step after the window, on its batch
        (its first ``rows`` rows where given)."""
        dev, cfg, vocab = self.device, self.cfg, self.vocab
        w = self.after_window
        state = w["state"]
        model = harness.reference(cfg, vocab, inputs.state_dict(state, cfg, vocab), dev, numerics)
        adam = state["opt_state"]["1"]
        names = [k for k, _ in model.named_parameters()]
        moments = {k: inputs.state_dict({"params": adam[k]}, cfg, vocab) for k in ("m", "v", "vhat")}
        start = {"count": int(adam["count"]), "step": int(state["step"]),
                 **{k: [moments[k][n] for n in names] for k in moments}}
        before = {k: p.detach().clone() for k, p in model.named_parameters()}
        paths = inputs.flax_paths(cfg, vocab)
        grad = {}

        def on_step(_i, _model, _opt, grads):
            grad.update({paths[k]: float(g.double().norm()) for k, g in zip(names, grads)})

        img, cap = w["batch"]
        batch = (torch.as_tensor(img[:rows], device=dev), torch.as_tensor(cap[:rows], device=dev))
        loss, = ref_train.train_steps(model, [batch], seed=self.seed,
                                      dropout=cfg["dropout_rate"], d_lr=cfg["dff"],
                                      warmup=cfg["warm_up_steps"], on_step=on_step, start=start)
        change = {paths[k]: float((p.detach() - before[k]).double().norm())
                  for k, p in model.named_parameters()}
        return {"loss": loss, "grad": grad, "change": change}

    def check(self) -> dict:
        numbers = judge.train_numbers(self.program, self.reference_readings())
        harness.free(self.device)
        numbers.update(judge.window_numbers(self.after_window, self.window_reference()))
        return numbers
