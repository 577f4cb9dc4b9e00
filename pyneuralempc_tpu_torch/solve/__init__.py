"""Interior-point solver and the Riccati KKT backend."""
