"""The port's tools: the reference-checkpoint parity table
(parity_eval.py) and the end-to-end quality gate (quality_gate.py)."""
