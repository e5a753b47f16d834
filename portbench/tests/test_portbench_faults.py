"""A run with its timed path broken underneath must come out not correct:
the harness driven on the CPU at a tiny size (float32, the language
model's too, where a sound run reads ~1e-7), the program patched with each
fault a cell can have. One chip, so there is no exchange between chips to
leave out."""
import pytest
import torch

import tiny
from portbench import harness


def _run(workload, seed=21):
    return harness.run_cell(tiny.files(workload), seed, 0.5, False, "cpu",
                            log=lambda m: None)


def test_sound_runs_are_correct():
    assert _run("naml.train")["correct"]
    assert _run("bert-naml.eval")["correct"]


def test_step_that_leaves_its_state_unchanged(monkeypatch):
    from legommenders_tpu_torch.data import device_pipeline
    from legommenders_tpu_torch.runtime import steps

    def unchanged(model, item_contents, optimizer, use_neg_sampling=True):
        inner = steps.make_train_step(model, item_contents, optimizer,
                                      use_neg_sampling)

        def step(batch, rng):
            before = [p.detach().clone() for p in model.parameters()]
            loss = inner(batch, rng)
            with torch.no_grad():
                for p, b in zip(model.parameters(), before):
                    p.copy_(b)
            return loss
        return step

    monkeypatch.setattr(device_pipeline, "make_train_step", unchanged)
    out = _run("naml.train")
    assert not out["correct"]
    assert out["checks"]["update"]["value"] == pytest.approx(1.0)


def test_loss_over_half_of_the_batch(monkeypatch):
    from legommenders_tpu_torch.runtime import steps

    def half(scores):
        return -torch.log_softmax(scores[:len(scores) // 2],
                                  dim=-1)[..., 0].mean()

    monkeypatch.setattr(steps, "neg_sampling_loss", half)
    out = _run("naml.train")
    assert not out["correct"]


def test_metric_altered_where_it_is_produced(monkeypatch):
    from legommenders_tpu_torch.runtime.evaluator import Evaluator

    metrics = Evaluator.metrics

    def altered(self, phase, scores):
        res = metrics(self, phase, scores)
        res["GAUC"] += 0.05
        return res

    monkeypatch.setattr(Evaluator, "metrics", altered)
    out = _run("bert-naml.eval")
    assert not out["correct"]
    assert out["checks"]["metrics"]["value"] == pytest.approx(0.05,
                                                              rel=1e-3)


def test_item_vector_altered_where_it_is_produced(monkeypatch):
    from legommenders_tpu_torch.runtime.cacher import ReprCache

    build = ReprCache.build_item_cache

    def altered(self):
        out = build(self).clone()
        out[7] *= 1.5
        self.item_repr = out
        return out

    monkeypatch.setattr(ReprCache, "build_item_cache", altered)
    out = _run("bert-naml.eval")
    assert not out["correct"]
    assert out["checks"]["items"]["value"] > out["checks"]["items"]["limit"]
