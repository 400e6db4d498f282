"""The port's versions of the reference's end-to-end training tests
(tests/test_system.py): training reduces the loss on the reduced
qwen3-4b, olmoe-1b-7b and falcon-mamba-7b, and PASA (fully-fp16
attention) tracks the safe fp32 flash path's loss trajectory on the
same data and init - the same schedules, steps, batches and bars."""

import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.data import DataPipeline
from repro_torch.launch.steps import (TrainHyper, init_train_state,
                                      make_train_step)
from repro_torch.models.model_zoo import build

torch.set_num_threads(2)


def _train(cfg, steps=30, batch=8, seq=32, seed=0):
    bundle = build(cfg)
    step = make_train_step(bundle, TrainHyper(peak_lr=3e-3, warmup_steps=5,
                                              total_steps=steps))
    state = init_train_state(bundle, torch.Generator().manual_seed(seed),
                             "cpu")
    pipe = DataPipeline(batch=batch, seq=seq, vocab=cfg.vocab_size, seed=seed)
    losses = []
    for _ in range(steps):
        state, m = step(state, next(pipe))
        losses.append(float(m["loss"]))
    pipe.close()
    return losses, state


def test_training_reduces_loss():
    losses, _ = _train(get_config("qwen3-4b").reduced(), steps=40)
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    assert last < first - 0.5, (first, last)


def test_training_with_pasa_attention_matches_flash():
    base = get_config("qwen3-4b").reduced()
    cfg_pasa = dataclasses.replace(
        base, attention=dataclasses.replace(base.attention, impl="pasa"))
    cfg_flash = dataclasses.replace(
        base, attention=dataclasses.replace(base.attention, impl="flash",
                                            policy="fp32"))
    l_pasa, _ = _train(cfg_pasa, steps=25)
    l_flash, _ = _train(cfg_flash, steps=25)
    assert abs(l_pasa[-1] - l_flash[-1]) < 0.35, (l_pasa[-1], l_flash[-1])
    assert np.mean(l_pasa[-5:]) < np.mean(l_pasa[:5])


def test_moe_training_reduces_loss():
    losses, _ = _train(get_config("olmoe-1b-7b").reduced(), steps=30)
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.3


def test_ssm_training_reduces_loss():
    losses, _ = _train(get_config("falcon-mamba-7b").reduced(), steps=30)
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.3
