"""Training planes of the port: LLM fine-tuning and the fed-LLM plane."""
