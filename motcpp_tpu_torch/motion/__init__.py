"""Camera-motion compensation on the host."""
