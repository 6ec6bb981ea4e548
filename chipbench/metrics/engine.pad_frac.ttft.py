"""Left-padded prompt positions over all prefilled positions of the
window's untraced batches, counted from the batches the engine returned (each row
padded to its batch's longest prompt)."""

UNIT = "%"


def read(run: dict):
    if run.get("kind") != "serve" or not run["prefilled_positions"]:
        return None
    return 100.0 * run["padded_positions"] / run["prefilled_positions"]
