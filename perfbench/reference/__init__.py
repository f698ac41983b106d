"""The plain reference that decides ``correct``: plain PyTorch and NumPy,
importing nothing of the program.  It takes the fitted trees and in-bag
counts (the program's model), the rows and labels the benchmark made, and
works out again the routing, the weights, the proximities and every
answer."""
