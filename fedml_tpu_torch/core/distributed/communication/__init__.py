"""Messages, observers and the transports that carry them."""
