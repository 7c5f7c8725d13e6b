"""The plain reference: float32 PyTorch, independent of the program.

Nothing here imports the program under test or anything made by it; the
modules import ``torch``, ``numpy`` and each other only.
"""
