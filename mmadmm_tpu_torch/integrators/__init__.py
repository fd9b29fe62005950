"""Time integrators of the port: MM-ADMM (2D and 3D stencil engines, the
stock element-major engine), explicit and backward Euler (2D stencil
engine, compact path), and the outer run loop."""
