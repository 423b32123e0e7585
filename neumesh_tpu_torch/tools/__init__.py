"""The port's tools: the reference-checkpoint parity table
(parity_eval.py), the end-to-end quality gate (quality_gate.py), the
editing gate (editing_gate.py), the editing example scene
(make_example_scene.py) and the correspondence alignment
(mesh_alignment.py)."""
