"""stack_occupancy (%): images decoded over the stack slots offered, that is
(`Stacked program inputs` spans x max_stack), in the window."""


def read(record):
    stacks = sum(1 for s in record["spans"]
                 if s[0] == "Stacked program inputs")
    if not stacks or not record["images"]:
        return None
    return 100.0 * record["images"] / (stacks * record["traffic"]["max_stack"])
