"""The paper's model as the serving path needs it: config, state, LIF
state, spike ops, the int4 codec, weight layouts and the artifact reader."""
