"""One kind of traffic mix a file, found by a traffic file's ``kind``
(byname.py). A kind file gives ``Traffic(mix, cfg, keys, prog, rng, gen,
device)``, which makes the mix's inputs in set-up and has ``warmup()``,
``window(seconds) -> record`` (``window_s``, ``units``, ``gates``, and what
the kind's metrics read) and ``check(ref, keys, judged=None) -> numbers
compared``; harness.release drops its ``prog`` before the check."""
