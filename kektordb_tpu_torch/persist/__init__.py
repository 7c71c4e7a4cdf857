"""Persistence of the PyTorch port: the AOF journal (resp, aof), the
checkpoint store (checkpoint) and index (de)serialization (index_io), in
the JAX package's on-disk formats."""
