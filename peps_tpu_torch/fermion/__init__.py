"""Z2-graded fermionic states on the card (port of ``peps_tpu/fermion``):
the graded tensor core (``graded``), the graded simple update (``peps``),
the snake-order sign dressing on kernel K4 (``convert``), the env-shared
ratio tables (``tables``), the graded local energy and holes (``vmc``),
the env-shared sampler (``sweep``), and the exact-coefficient oracle
(``exact``)."""
