"""The one constant of ``repro/core/energy.py`` the port's serving path
reads; the energy model itself is not ported yet."""

STEP_CLOCK_HZ = 10e6          # instruction/step clock (Tab. 3)
