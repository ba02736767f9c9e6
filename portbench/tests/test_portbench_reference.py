"""The plain reference against the program's CPU path at a tiny size:
the same weights and batches in float32 give the same losses, gradients
and Adam steps."""


import pytest
import torch

from portbench import checks, frozen, registry

from .conftest import TINY


def test_reference_follows_the_program_in_float32():
    from tpusnap_torch.models import Transformer, TransformerConfig

    cfg = {**registry.config("transformer-big"), **TINY}
    ref = registry.reference(cfg["reference"])
    tcfg = TransformerConfig(vocab_size=cfg["vocab_size"], d_model=cfg["d_model"],
                             n_heads=cfg["n_heads"], n_layers=cfg["n_layers"], d_ff=cfg["d_ff"],
                             max_seq_len=cfg["max_seq_len"],
                             dtype=torch.float32)
    model = Transformer(tcfg, device="cpu", seed=3)
    weights = ref.init_weights(cfg, 11, "cpu")
    flat = {}
    for k, v in model.params().items():
        if isinstance(v, dict):
            flat.update({f"{k}.{n}": t for n, t in v.items()})
        else:
            flat[k] = v
    assert set(flat) == set(weights)
    with torch.no_grad():
        for k, p in flat.items():
            p.copy_(weights[k])
    feed = torch.from_numpy(frozen.tokens(cfg["vocab_size"], 3, cfg["batch"], cfg["max_seq_len"], 5))
    losses = [model.train_step(t, learning_rate=cfg["learning_rate"]).item() for t in feed]
    want = ref.train(cfg, ref.init_weights(cfg, 11, "cpu"), feed, cfg["learning_rate"])
    assert losses == pytest.approx(want["losses"], rel=1e-5)
    after = {k: (p.detach() - weights[k]).norm().item() for k, p in flat.items()}
    assert after == pytest.approx(want["change_norms"], rel=1e-3)


def test_gaps_are_relative_to_the_larger_of_leaf_and_median():
    want = {"losses": [10.0, 9.0], "grad_norms": {"a": 1.0, "b": 2.0, "c": 1e-9},
            "change_norms": {"a": 1.0, "b": 1.0, "c": 1.0}}
    got = {"losses": [10.1, 9.0], "grad_norms": {"a": 1.1, "b": 2.0, "c": 0.5},
           "change_norms": {"a": 1.0, "b": 0.9, "c": 0.0}}
    found = checks.gaps(got, want)
    assert found["loss_gap"] == pytest.approx(0.01)
    assert found["grad_gap"] == pytest.approx(0.5)  # c's gap over the median leaf
    assert found["update_gap"] == pytest.approx(0.1)  # c left out: its gradient is nought


def test_fp8_cast_rounds_to_three_mantissa_bits():
    ref = registry.reference("flagship_transformer")
    x = torch.linspace(-3, 3, 1001)
    y = ref.fp8_cast(x)
    rel = ((y - x).abs() / x.abs().clamp_min(1e-3)).max().item()
    assert 2 ** -5 < rel <= 2 ** -3
