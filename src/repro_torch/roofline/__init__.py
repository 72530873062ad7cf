"""Roofline of the port on the H100: a step's counted work
(``analysis.analyze_step``) and the JAX package's analytic model
(``analytic``), both against the card's published peaks."""
