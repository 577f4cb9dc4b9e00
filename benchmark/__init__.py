"""The benchmark of ``pyneuralempc_tpu_torch`` (see README.md)."""
