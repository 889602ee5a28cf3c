"""Plain references that judge the program's answers (PyTorch only; they
import nothing of the program)."""
