"""MPC primitives: the finite field, Shamir shares, LCC, LightSecAgg and
SecAgg's mask arithmetic on tensors."""
