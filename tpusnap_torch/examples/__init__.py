"""The port's user journeys (counterparts of the JAX package's
``examples/``), each runnable as ``python -m tpusnap_torch.examples.<name>``
and callable in process as ``main(argv) -> int``:

- ``simple``: an epoch loop with resumable state (``--resume-from``);
- ``incremental``: a frozen tower and a trained head, incremental takes,
  ``verify``, retention;
- ``distributed``: data-parallel ranks taking ``replicated=["**"]``;
- ``transformer``: the flagship (MoE) trained with an async take per
  epoch and a resume through ``async_restore``.

Each runs on the card unless given ``--device cpu``; without a card it
exits non-zero and says so.
"""
