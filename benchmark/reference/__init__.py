"""The plain reference the benchmark holds the port to. It imports nothing of the program."""
