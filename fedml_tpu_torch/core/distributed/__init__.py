"""The message plane: messages, transports and the node runtime."""
