"""The plain reference the benchmark judges the port's output by: frozen
NumPy copies of the port's golden model and of its decoder's parsing half,
with the format's constant tables. Nothing here imports the program."""
