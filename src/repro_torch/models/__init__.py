"""Model families of the port (UViT so far)."""
