"""Time integrators of the port on the 2D stencil engine: MM-ADMM,
explicit Euler and backward Euler, and the outer run loop."""
