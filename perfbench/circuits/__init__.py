"""One circuit a file, found by a ``circuit`` traffic file's ``circuit``
(byname.py), on the reference's side: plain NumPy and PyTorch, nothing of
the program.

A circuit file gives ``draw(rng, mix) -> (values, groups)``: the plaintext
operands of the mix's ``pool`` requests, drawn from ``rng``, and their bits
as groups encrypted in one call each, bool arrays (k, [width,] pool,
batch) whose leading axis holds k operands (a word with its bit axis, a
single bit without); ``want(values, mix)``: the result bits, bool (pool,
bits, batch); and ``circuit(gates, *words, width) -> (a, b)``: the circuit
over a scheme reference's ``gates``, on words (a (width, S, ...), b (width,
S)) and bits (a (S, ...), b (S,)) of S circuits, the result with its bit
axis first where it has one. Its program side is the program's own function
of the same name, which the scheme's file of perfbench/drive/ finds.
"""
