"""Plain PyTorch references of the benchmark's models, one module a model
(``<model>.py``, named by a configuration's ``model``), over plain geometry
(``geometry.py``) and layers (``layers.py``), with the plain colour attack
(``attack.py``) and Adam (``adam.py``).

They import nothing of the port, of JAX or of the JAX package, and take
nothing the port has made: the benchmark makes the weights and the inputs
and hands the same to both sides. Each follows the port's order of
floating-point operations (the JAX package's association, written down
in the port's docstrings), so that on one card the two agree to the bit
where the port's own arithmetic is deterministic.
"""
