"""The paper's FlexVector tile: hardware configuration and PPA constants
(the simulator itself is a queued slice)."""
