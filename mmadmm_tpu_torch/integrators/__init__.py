"""Time integrators of the port (MM-ADMM on the 2D stencil engine)."""
