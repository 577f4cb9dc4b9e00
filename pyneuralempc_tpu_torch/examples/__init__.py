"""Worked problems of the port: :mod:`.quadrotor`, the quadrotor fleet."""
