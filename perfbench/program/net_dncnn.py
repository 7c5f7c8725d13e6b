"""The port's DnCNN, loaded with the benchmark's weights."""


def build(cfg, channels, state, device):
    from deepinv_tpu_torch.models import DnCNN, autocast

    net = DnCNN(in_channels=channels, out_channels=channels, depth=cfg["depth"],
                bias=cfg["bias"], nf=cfg["nf"], device=device)
    net.load_state_dict(state)
    return autocast(net)
