"""A frozen copy of the SLAM engine's plain paths: the reference that the
benchmark holds the program against.

Copied from the program's modules of the same names, with every call of a
hand-written kernel replaced by the plain PyTorch version beside it
(``plain.py``), the pose-graph solve always eager, and a switch for the
lower precision of the check's control (``plain.lower_precision``). It
imports nothing of the program; later changes to the program do not reach
it.
"""
