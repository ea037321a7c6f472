"""Power-flow solvers: dense Newton-Raphson and backend resolution."""
