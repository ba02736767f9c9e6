"""A configuration names the program's model and any field of that
model's config: the job builds the class it names from every key of the
file that is not the harness's own, maps dtype names, and refuses a key
that it cannot place."""

import time

import pytest
import torch

from portbench import harness, job, registry, run

from .conftest import TINY, TINY_RUN


def test_the_flagship_is_built_as_before():
    """The ten keys the job used to pass by hand, and every other field
    at its default."""
    from tpusnap_torch.models import Transformer, TransformerConfig

    cfg = registry.config("transformer-big")
    dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    before = TransformerConfig(
        vocab_size=cfg["vocab_size"], d_model=cfg["d_model"], n_heads=cfg["n_heads"],
        n_layers=cfg["n_layers"], d_ff=cfg["d_ff"], max_seq_len=cfg["max_seq_len"],
        n_experts=cfg["n_experts"], rope_theta=cfg["rope_theta"],
        dtype=dtypes[cfg["dtype"]], param_dtype=dtypes[cfg["param_dtype"]],
    )
    cls, got = job.model_of(cfg)
    assert cls is Transformer and got == before


def test_without_a_model_key_the_model_is_the_transformer():
    from tpusnap_torch.models import Transformer, TransformerConfig

    assert "model" not in registry.config("transformer-big")
    cls, got = job.model_of(dict(TINY))
    assert cls is Transformer and isinstance(got, TransformerConfig)
    assert job.model_of(dict(TINY, model="Transformer"))[1] == got


@pytest.mark.parametrize("name,want", [("float32", torch.float32), ("float16", torch.float16),
                                       ("bfloat16", torch.bfloat16)])
def test_dtype_fields_are_mapped_from_their_names(name, want):
    _, got = job.model_of(dict(TINY, dtype=name, param_dtype=name))
    assert got.dtype is want and got.param_dtype is want


@pytest.mark.parametrize("extra", [{"d_modle": 1024}, {"experts_per_token": 6}, {"dtype": "fp8"},
                                   {"model": "Moe"}, {"model": "make_mesh"}])
def test_a_key_the_harness_cannot_place_is_refused_by_name(extra):
    (key, value), = extra.items()
    with pytest.raises(harness.Refused, match=str(value) if key in ("dtype", "model") else key):
        job.model_of(dict(TINY, **extra))


def test_a_named_model_and_a_non_default_field_reach_the_run(monkeypatch):
    from tpusnap_torch.models import Transformer

    built = []
    init = Transformer.__init__

    def recording(self, config, *args, **kwargs):
        built.append(config)
        init(self, config, *args, **kwargs)

    monkeypatch.setattr(Transformer, "__init__", recording)
    overrides = {"config": dict(TINY, model="Transformer", attention_impl="reference"),
                 "mix": TINY_RUN["mix"]}
    result = harness.run("big.sync_mem", 2**31 + 23, 2.0, False, time.perf_counter(),
                         device="cpu", overrides=overrides)
    assert result["correct"], result["checks"]
    assert built and all(c.attention_impl == "reference" for c in built)
    assert built[0].d_model == TINY["d_model"]


def test_the_command_exits_3_and_names_the_key(monkeypatch, capsys):
    """``run.py``'s own path past the look for the card, on the CPU."""
    real = harness.run

    def on_cpu(cell, seed, seconds, trace, t_start, bench=None):
        return real(cell, seed, seconds, trace, t_start, device="cpu", bench=bench,
                    overrides={"config": dict(TINY, n_head=4), "mix": TINY_RUN["mix"]})

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(harness, "run", on_cpu)
    code = run.main(["--workload", "big.sync_mem", "--seed", str(2**31 + 29), "--seconds", "1",
                     "--trace", "0"])
    out = capsys.readouterr()
    assert code == 3 and out.out == ""
    assert "n_head" in out.err and "TransformerConfig" in out.err
