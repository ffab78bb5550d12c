"""Share of the traced window in which no operation ran on the card (1
minus the union of device intervals over the window)."""
from portbench.metrics._common import idle_share


def read(run):
    return idle_share(run)
