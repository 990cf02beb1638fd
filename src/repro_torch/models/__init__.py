"""Model families of the PyTorch port (dense so far); see :mod:`.api`."""
