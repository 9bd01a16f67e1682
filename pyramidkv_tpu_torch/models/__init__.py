"""Models of the port: the Llama-family decoder and the weight bridge."""
