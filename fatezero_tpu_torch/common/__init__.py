"""Config, image I/O, checkpoint reading and phase timing for the port."""
