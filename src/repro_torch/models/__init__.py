"""Model families of the port: the SSM family (Mamba2) so far."""
