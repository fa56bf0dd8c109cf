"""The plain reference the check compares with: PyTorch and the standard
library only, nothing of the program."""
