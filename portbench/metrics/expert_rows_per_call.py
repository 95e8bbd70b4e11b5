"""Rows a held expert computes a call of the expert layer: the window's
token-expert slots computed by the held experts (the model's
``expert_slots_held``, summed on the device) over its expert-layer
calls (``moe_layer_calls``) times the experts held
(``routing.held_count``).  None on a program or a model that counts no
such slots."""


def read(run):
    slots = run.stats.get("expert_slots_held")
    calls = run.stats.get("moe_layer_calls")
    routing = run.model.get("routing")
    if slots is None or not calls or not routing:
        return None
    held = routing.get("held_count") or run.model["moe"]["num_experts"]
    return slots / (calls * held)
