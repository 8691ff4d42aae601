"""The plain reference that decides ``correct``: plain torch and numpy,
importing nothing of the program or of JAX, and working every table, tree
answer and draw out again from the raw scene files and the seed."""
