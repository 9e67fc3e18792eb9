"""Glyph coverage of OpenCV's FONT_HERSHEY_SIMPLEX at scale 0.75, thickness 2.

Made by ``scripts/make_text_atlas.py`` with OpenCV 5.0.0 (each printable
ASCII character drawn alone with ``cv2.putText`` on a black canvas); do not
edit by hand.  :func:`glyphs` maps a character to its coverage (uint8
``[h, w]``, 255 = fully painted), the offset of the coverage's top-left
pixel from the text origin (x, y) and the pen's advance in pixels.
"""

import base64
import functools
import zlib

import numpy as np

FONT_SCALE = 0.75
THICKNESS = 2
OPENCV_VERSION = "5.0.0"

# Character code -> (width, height, x offset, y offset, advance).
_INDEX = {
    32: (0, 0, 0, 0, 5), 33: (4, 15, 1, -15, 5), 34: (9, 7, 0, -16, 9), 35: (14, 15, 0, -15, 14),
    36: (14, 21, 0, -18, 13), 37: (17, 17, 0, -16, 16), 38: (15, 17, 1, -16, 15), 39: (5, 7, 0, -16, 5),
    40: (8, 21, 3, -18, 13), 41: (8, 21, 3, -18, 13), 42: (9, 8, 0, -16, 9), 43: (13, 13, 0, -13, 13),
    44: (5, 6, 0, -4, 5), 45: (8, 3, 1, -8, 10), 46: (4, 4, 1, -4, 5), 47: (11, 19, 0, -17, 11),
    48: (13, 17, 0, -16, 13), 49: (12, 15, 1, -15, 13), 50: (12, 16, 1, -16, 13), 51: (13, 16, 0, -15, 13),
    52: (14, 15, 0, -15, 13), 53: (13, 16, 0, -15, 13), 54: (14, 16, 0, -15, 13), 55: (12, 15, 1, -15, 13),
    56: (14, 17, 0, -16, 13), 57: (13, 16, 0, -16, 13), 58: (4, 11, 1, -11, 6), 59: (6, 13, 0, -11, 6),
    60: (10, 14, 0, -14, 10), 61: (10, 9, 1, -11, 12), 62: (10, 14, 1, -14, 10), 63: (12, 16, 0, -16, 12),
    64: (16, 18, 1, -15, 17), 65: (15, 15, 0, -15, 15), 66: (13, 15, 1, -15, 14), 67: (13, 17, 1, -16, 14),
    68: (14, 15, 1, -15, 15), 69: (12, 15, 1, -15, 13), 70: (12, 15, 1, -15, 13), 71: (14, 17, 1, -16, 15),
    72: (14, 15, 1, -15, 15), 73: (5, 15, 1, -15, 6), 74: (13, 16, 0, -15, 14), 75: (13, 15, 1, -15, 13),
    76: (12, 15, 1, -15, 12), 77: (15, 15, 1, -15, 17), 78: (13, 15, 1, -15, 15), 79: (13, 17, 1, -16, 15),
    80: (13, 15, 1, -15, 14), 81: (13, 18, 1, -16, 15), 82: (13, 15, 1, -15, 14), 83: (14, 17, 0, -16, 13),
    84: (13, 15, 0, -15, 13), 85: (13, 16, 1, -15, 15), 86: (15, 15, 0, -15, 14), 87: (17, 15, 0, -15, 17),
    88: (15, 15, 0, -15, 14), 89: (14, 15, 0, -15, 14), 90: (13, 15, 0, -15, 13), 91: (7, 21, 1, -17, 7),
    92: (11, 19, 0, -17, 11), 93: (7, 21, 0, -17, 7), 94: (8, 4, 1, -16, 9), 95: (14, 4, 1, -2, 15),
    96: (6, 4, 1, -16, 8), 97: (12, 13, 0, -12, 12), 98: (12, 17, 1, -16, 13), 99: (12, 13, 0, -12, 12),
    100: (12, 17, 0, -16, 13), 101: (12, 13, 0, -12, 12), 102: (10, 16, 0, -16, 9), 103: (12, 17, 0, -12, 13),
    104: (12, 16, 1, -16, 13), 105: (4, 16, 1, -16, 5), 106: (7, 21, -2, -16, 6), 107: (11, 16, 1, -16, 12),
    108: (4, 16, 1, -16, 5), 109: (18, 12, 1, -12, 19), 110: (12, 12, 1, -12, 13), 111: (12, 13, 0, -12, 12),
    112: (12, 17, 1, -12, 13), 113: (12, 17, 0, -12, 13), 114: (9, 12, 1, -12, 9), 115: (11, 13, 0, -12, 11),
    116: (10, 16, 0, -16, 9), 117: (12, 13, 1, -12, 13), 118: (12, 12, 0, -12, 12), 119: (18, 12, 0, -12, 17),
    120: (12, 12, 0, -12, 12), 121: (13, 17, 0, -12, 12), 122: (11, 12, 0, -12, 11), 123: (9, 21, 0, -17, 8),
    124: (4, 25, 1, -20, 5), 125: (9, 21, 0, -17, 8), 126: (10, 5, 1, -9, 11),
}

_DATA = (
    "eNrNOwd4jWfbzzkn42RHiBjhRBCSBjGqaq8aLaXGrxW7RKlNjaoawWd+tqI1qnaNllKrRopQJMFnhcSICLJknyTn"
    "nPu/72ec9+jXfl/7jev/n+tK3vt+x/M+73PvcWaYzWPXAiz4Z39tV65sWicystZhgJ0/Auz+BmA1qxkRwgIj6ugN"
    "VrB53AB4g2VAoe4MQE12De6x7QDu7AicYosgi7F1sJmNggTGyrXyZ24tqzE+9Hr8Z9AJpIutwImNg5sCmwVpDOeI"
    "QbBSZGQM3I+MTIRzkfXZNNDGcTbeAfue6Ss1BBhUqRdAq0pu+GQbgDAWBRZXPuVwsLiwJZCEoFNSRgHYMjLMUJrx"
    "NNDdYRKoo5u2IBdiFywBOLIg2h3vLYGPWQ2ADnySILA1Z29BcSDHdLWq4w2hVZh9VKqgwext2hX7+B+AtgoOXZ0L"
    "kLGuCUe22sSrrcMRCUfg2f4zRQC29ozh7qfil4TlAWxh7ArAMXqg/oABTRlbhk98VV/uHmuYTVM82/iuG0dD4sSc"
    "BWPF5bDPr/K3LFcrCBjzDCDHqcyo0R+6EN4fL9YPojuIKEjhYk96H/xt085kPJxgrNpttUdXK+EtZWdctAJYLnzm"
    "KWfsB9BZ+9quAE01TFctSIOdmOOouOhh+oY6HJxeeFdP35z5CGIJ72SFfox559sCndKgEWNV0mE9nq4NBYydgf7M"
    "+TzEGfFEDSjWsVjog9R9WYO/IgGGdyjM9e1mg57iLb1LcUOjq2VrG1B2yDiT62W46BI4rp+3OrkGMk3z8LOKegi8"
    "D9i6+OSWDF4CFzleKxcW4MmLzKUUTIi7X4ezTmwAnGasAGrjiY3wHDenBSTqA2z5OO0gsLSnB6/A+buwCpkl1TKN"
    "z9RoT/6ztZVe2Ql3g4KqeGpny2x/CqXx8jOY/01OAUt/gUYBXGgxzALXBboZoBtjZ8HmztEpKLssNAfuylkzwboh"
    "B6y95Fwf0Ew5kRJrcJdQnNf9zI15LDgL4DFAfmv8WpjL9qHUu0YjO7U9A5aaLI0Ei80BKAH4irEbQjpQZOCpHz+m"
    "j+zwyQtiv9bINzcl2+CJ/BaMeW16ZAPb/eHOy6yQzXe+zGvu9s8ltcJVClcnXJVwNcJVCFcfNJwajgjAQ4tMgL6M"
    "dSzA2bszhl+wszljTQBiDZyYyBI4fgHg3PcAcvnDBfCEDh4Ad+hYGUgxcfyu43X7/fi8STAH9KYjzv8zCQlLBPj6"
    "dTx2LsT3v4tA6xy+HsZc3hhVqUZUXU7QCbgr9fD4Ed6UhfpA3x716FlO8Ltg4ysbC/CZnPl7OnqCEACdBe7zJeTI"
    "paDMGhxwdV3dr54fAzADD8ZbYKvGdC2+4+9DXoGXqHEmIiUakooY0cBZCevGlSSUXh5TIFuPGmzLkxVwZZs12Oml"
    "oNxE3eB5uMfHPwllXschC/Jxs2tnw8D7sI504mrXHiOkHvKs5qWx7iE4pyEnIe6fIAHbdu3a9Qyy8P+2qs0cdHLH"
    "ykdPnjyZCbn4/1j1PzgbH8fhsoaEvBMmgOqTp3RlmwC+YJcAGulykP7IBKNY+XVLPdisi3zsOykV6DdmPhI7TpnS"
    "NBZgP/4dOARcEdEIjIkfLcEFgglo41/AAynMqFenyOuxUOQvZQ0ZR578ym4jyhTYF4tmbbBUlnchQ2h0tDqwWF4/"
    "ANZgAVW1wA/y5FyAtwXk8gzu6+0yPkle/xkK/QRUF2CTPNnr8rmwV5RQYICCGp5Ek/Li+5oEjyoVu1GMeijEjMCF"
    "ayTQfrSLttbMn659xhIA4lHrpCPXHNIVA/yVGR7M3wXw0BUvT2ddLVXXATwnczuVHT1Axi2dX6lpe4vRFXpm6V/v"
    "6NgOgEco+pCYNZbpUNkcofcA+LDu+H82C0O1A6d/IXkqz9inkkuK+9FK28Sj6cw7XVd+hKFGkLKQhjn55lyxbf4n"
    "6IEGBDZNAQX3LOEKjcOtLXD1PXXPmOXGugoW2/dvw83uJSXRm58kJW3rq3H6TTR5anAVYQgxKZfhR9Qy6cfQDLJ3"
    "i8Ud+e+wAFSqBd//jLY90zCM0wJ9KGTq1aij8M4IUukeVau6CWsAr4m52uBUVwSHvI2uRX5tzmrT8d2ZLQh0RqJB"
    "SigH99Eqa9rB1BD+2Dp6f2YSjRWPtfWfjtfgb1nXIrMcLyuzYdqVcNbyahwNC36R5EkDzpgeIWDXPQjXE7AXkupF"
    "XTvfAyQvlF7UDTHZCv4dncaMWU4nRinudUVVecCpXce2BvlgcoCNzCG6aMi/36CRBIhZ/gNp7vdY4BO5Mus8vN17"
    "9hO8Nf1UJzmVW6ijnQ67YzY/UojbdXzIpnkPDhhyT4YdQ9ObO1BhhhgU7+YKmwWwlymspQVSyyrM7zGgYCjscwDz"
    "tWvX7pPNzum9xNFnHTMylY9Mok9qd7mALg4r+zXWzAovODBGUegaI39bjmxETgPc5kT6lnHLGmx/GDnGTcHeALl9"
    "t57dNdmHO2ZypKE70JbEc18MsmpWEAuYMXMyimrLQgcPlGEoEatbsGolmVC08WjC/oYij65P3XyAaNoYSF6zC02q"
    "rSnz3K+kfAAFDlOvIBHTf1T+tHPdag4Uml1ofuFs98GRlJPt3jlKywm90genkLMqqkszcO6FSve1sPB3PRhEusOY"
    "rD5rt46bVrg7ZwbRfRwjjXfbFw056qKbzNVCrpJQ31Zv/QtSgOTVotl1or1NQVtf4Q6Rm/Uggd21DXnU9h7eMrhE"
    "vKB0AH99+72P8O49He1fVKGqOPawC1Rhm5Ea/fu8++w5DbLW0gSwlch+0qvyRYLNk6c/wR2U3Oz0iORA+bmairoo"
    "VQ8pR+FX8YEyqYxKEFqDMfL0UuQWafK9XmoW6l3cW4ewiFUubwd7nkK5SDvWmiNzZOxTMoJEC4EfB0ddwDV6cz/l"
    "Mm64SwpJKJuNppceQIuNer49uuj93b0n2cBKDtQycolJc3JTPFsJM81J8eL5mdGkl4YxdgtgB36Ey2lSj+XU1yFN"
    "S5z0LyVvopZDO7wNL27q9cFePMxkzMce+2wn1nf/5CGuOztGbQIz1q6qc4h2gvwV2O4cBXoHuY1dpL41iodHkHXg"
    "J5SOonB2GSAJA8q2yAVrnZGxZ9HdqKBijSXSezgKGHNcBYhD6aiN0rGWDabYLHoFMpk1XKpjGl/Q3d1iSa1Boock"
    "NPJecSOlB2yaR1ApHQNKSVP9T2iAVfDaAW2C4L55t28vQjk9TX9vR0d3dXQV6kZG1kNX9ie6hgHjbtb59u1zem5/"
    "XOX/kOjo8ew3RtkJUwZzCsdQyASDGLsAObjcLPoA/YrVVbVbXcqoAOXGCvE5n5fAGm4RLwuK6yegyU9/n7FgUur7"
    "UIhro9JI575/Nzwzj3+i227S+Dw8ZH0xuskfw09XRsUDZ3g4r4vKlSKLQctZ8Q7amXFDg7vJEbbNbuk2K+iEZ4gc"
    "vr/1qUsK5NixQz0R02qmHF387THf/tgQCX0PBaMFNy3Em0/yvdB/jEL8chA/G4yKC77juko3Ek+ncW5zwX0E8usb"
    "oONkW2VgLrORe56gEQtNIL6lbfwWt6WXfMdBSexpg18NQkOkbvecm2wF68OZruhkKgt/yVmH7q/t8tY0MrUkrp8i"
    "F+FrdrVLz7iKobhzhn0HyS+zStf2I2S6hdIsIrhH8JwR7dVN+bZ3cK4B8sFWP5067KeWExGhHCD2GVAqSQyMPfMV"
    "jOL70L5+Q0j3TiEuCqt9tIiHywkiM/GpGSzXN++6hicPoXLsBbZpXEYM3fNgGauQYf2QwgQn5qWrn2Ft/BFyp77X"
    "Vcjehmp9PczdjRq/NYoqPr2K9YYTD6EW+wvM0QckIV4RnmdDGRaHzg369KvQMObnoMOaAvgli2A184XsF1ARL71N"
    "nvhZ1hjiTmHU3BNSZh7DcPjMI5g/BrWn59e4m8nRqBeOephsWfjtgZMGeLGAtsHcYF6SaRTDuP2oad0OgHnd0HZv"
    "dp96E0po6YYvLJJS51pJKjYbveXAiomv2/dnbpG5aLFGbRQUKLSnP3hGAD50MNDxmjGoaIHS0GKKKPmYBHCY/KoZ"
    "Ar1OkW9PgHucc9HvzPNgrlkyCfRXgK14WA88XnRCs/fTmjVrjiE9jYL0amB8vdsBPch8cbOnNqCBCqWkPMaweSI3"
    "YsS5x6Kbukyu7i8Y+vYQtjEndj1usmYfrZMJKV2yZMlB4oYwRAroEaQljFCIN9q0ORLxJ++qPSK29PR0C9eq2mxF"
    "rflsixYt2oayV9xUTeCPOnetQkhh/80+Nd63HZGSWbNmbSAfbZCD7V5p6CMAy81v+slvcaqh8j/+K1GV21K/IrJX"
    "u6tcoIGs7FM8ZnxLVsnc9H2SQ2eRwtuJ8WSRtwh94ck91BOCdr16d3ihBa2MZToir1xJkoaWle3UqSkquQK+loMA"
    "T/uRz4Oi25Oc+4AsChE2XcbtsbRjr6WovSYLXGXzNdzN7N3hyjqGlxPuCydP7oU1Q8lb1DYhoRLHrHFxSYQ+rMrk"
    "1oUuQnS8wpjhKeU37HuMXJWlt2Mf4q2edmwAYmVeueZlx9CTfqk99x3xscL6WSg2pbXExMTSF74MdVhnWoTwlJD8"
    "t/bMCLJ/EXfImjsQtQfCZu48x12JQDhRbe4/gEsS+dju8L67BJsv87GO/cF5CmPEeMdhPTP6aPBIbc25QQ731Kev"
    "5m7k8xQTwukOc/4enD+Vj04Oa/7ZAY4hOG8kHy3ZH5zTDuOab79imgw17Iqq7LJz6AWl7eOBYXUlGNZoxspR2jFz"
    "z3lKWAxlfaVotEDhvMW24oq5rzpg+/Yv9Q/JZbGPdC4DLpNn4JjiKsQjREwbKuQj4EUO5RlD7QJCyYgqm3DHiZvZ"
    "fIwXuAKdhiY9/CklRstlUEp+8xGU/9L2aIweynXm8siy8saEEpL6+vaQNUw6bEghkYkMyTO/rGjn1Cb09j+FFfrR"
    "6CAxbfwGVkSj+E+/4XexDyiFw720EjAH9jSbn7uMlBL6L/9DjshxZf3t/GteSfGMGgdY75QnfJQQosb1/wSi8/Nz"
    "lzlh2InLKKaESE1SThTzbtIxJ3LV6uso1f3LBnKXHhhY8DO5slsUCQXMRxaz3PiyrJzWL9xdEZsSls57i8y5/oL/"
    "deRbTpLCMBM493FkIDpPx50F0g6/8qbUo0UYuzyvxuxKtbAJ05BbHg4I7NNLJItyYHOV0Plg6G2LVBIYhCsvaqLE"
    "sTGyfVoVJZs9MM6K91DCOQ7DlalI3RSdJsHw/wHmqamk24GOGk7TgsXVMZQ+Ju/v+NJ8lW7rK4wvxojPCU12lRUW"
    "gcIEcqee2tHMMoI2HMU9WcQq5NGR0GvXoMj0BYbXAo3vAnCqFH55T6LoAOJo112hzXkt046yQ2Br5IBWGNaZOaBK"
    "9/wa7WOjKp3woK1wE/nqsF44veZFtOKPZYqKXBHIreKAoJ/lgJATpiFpZRRy8xrpNInENywFW2uFkPeVuFEhRtzB"
    "QoWwN7lLKhGy2Rrifs8BYa2Rubf3AfkRS2wgw73qql7ou/R8ARSeX0phVhWZ/YMbVZk3OR8J2+Pw+dQy3UVQQu4p"
    "9ML1pfJHH6EM3aaUJI2d6KW+oBiaxnLUKZlUz6axGFXYK1fuy4IK24tuCar6Inq3F37c1kih6Q2kgAYG5FLpa2sq"
    "/s+rxCJSlb9A4Zhpx20LWO7sVBkq99fcHZwhc/KBWQGOvtDjRhw5fOiH51R94IoPGdGJ3tNZIswdjd9ihZiQ6aZz"
    "/ejs0owypE0ceP62k4bs9+ZT7/z664X9G+jES/0cLO8fQZA+ee6vWGVnO338ll0ohAJBH9MtjT5lSGjit1MUmurb"
    "C/9/gjdMJjcJReQxfxQpuPYOBoYcwSj1lp0KVCSw02cFOmT2K0jcDDt90D9NVvTxRZ10SNGHqgNzOH1St9I6sito"
    "9IG/KPoAqriMyoI+4T5lH8pCu8h2fTi0hyBW0cPT070ciZURQYjl0KEjVH2/r9xPF3Jb31L2MJAKaAppL73DovDw"
    "eiORh0u8HYi1Rpu6KEo4hfPn70GnpTKTHqrxEa8cydmGoOJppBAD8vfPOvUe8tF795E2WHcEAy6Rmaqq5eGGnEYH"
    "N+sQz7MbNzr67+Qup+07i9toac4d5AfIZ/UKuR26Lne80YABjTkNrOvrKb3bmJcLUze8YxSWP0HMmRclLteZncAz"
    "YPPspf+J6VT18R81egjP1w7FizVr4D2LSXFhcJfhxM4TD23chXaX6r+1rtn9TEqLuC28ROWLK1NVFkUfHCRyCxM0"
    "J8G8yTFZfmy6A7KLOTs716A0IB75V5gQ6aLW93+ClCsCSzP5CYIJB5nN8YtBdsZMw135LyKfIUH4Di5DE/oWyPgd"
    "Xd4d3igl2/2Y4QNuSsiCmY+QIJWEMb9zyrGlNgC35VfNYHtwQOWTnUNFBq+v2XxDJGa65Jmf62uB6qk5wLnzhkxe"
    "eiCfjeRlkae0kB7IYRWRd+RSvhF1LSpILMaps3gWnjvf93ja0sazZQ2pkYdUxyWxhGSAz/Wp9kIA8kP8m3iLKCUz"
    "Ar/VbKlOxLKfMS2TTg6tQlvxOp0WlMSjc89NK3ut0JykkpVsYJH5KCWY29nzexRu4BrGqhP3qCZ6lDdQtNn5hRvz"
    "sFL9eDFfdAy1LrwB1LiAUX2+3p82n+QjR8dretWHkCpzRn14DuMG9AS7HwS8pf1psYnozC0ohDUvYVUG30wyebhV"
    "jbfQf2gu0+KQpOvEK1Y+oj5EkumcDjKbVpVO1BWp5UN8X7LFd7e2i/A3YKHJ9ejttMHzZnP+UB7HXDCbdzMDSm5+"
    "dVEWtyJD10K6xui5O7BU5o9gvDvS8Q5PARpi0WlAK2uRXUO1eeIOlqjdInshb+W9AlQxmWGnAk8a5akS1ftSRQit"
    "UBHNxx2qHwvq/4D0auyOxsZcV6qc2ajNcLoEFxaEduKKs6jZoHFYjV4ep7sBfeUirylm82kx5ehCc3xQEQWYVJzJ"
    "Jd8QVf4zb94ARI6jbwavNTZEkr7PeEnWHKxDmblESsYFrdZe8kVbiNYkcibtAQclWFGoaqlCnbALzJ4ahgJNg893"
    "THz+CWwCfqWAHmlachqzaYpxFYsToZTZQV83RuSJfHsACkmJJJUzpd3HOEjLLglTEuaWTGU1QPLnSSEqR4FwH5nr"
    "oj6LFcwumHBelu6q0XKeCzd+a4SD0r5Zrdih4PzOehxrq3zNse78YGuDhz5GV4YH6uP6Lx2+iBrqI1+7RRzqRuEY"
    "6vNBfKzKfDUSiU9ZVysqp22MagoxvoBkvZbDVGYgyAJHNKJbpaZiHbUKmy4RMoxav8hAZu8iuaQe3ACgyj4RWssH"
    "O2dvBKH8yERmbxq5p9daSVTxu9KZy8Prr6NNbjSFf+X0KHFgRuMUOvAyzn/lEBgVhWp5+mTxPnH4NJD2OAq1/PCj"
    "P7xJnSlUD2/Mhthyp262ZtUdMqkSY69Pb9VxgMNomOuY7jjxKvbqnZ9lZ8dXZEY0M5dQ10y2kNPBQjtwJ6lc807S"
    "121wmgd+w1Caw3NQJCmpO5xHDFtcnOYA1dZdyxOxyWxRubX8+B+TKQ4KY9UOlgh5R3gHwJHeAZRlCnvNCvcNIoUb"
    "hkyT196X8rUQphNxTh6/33cvClFC03QwU73KOUyWq30jIuxNV8iJKxW8wyGt+3dw2fYNXQS8cwdKWt5ADquCModP"
    "fjDmCRoJPcIPjKJkWXOH6FwiW/XeDqmZUC0M2iGSaT44VVeEn/py3oJgmufyhAVodu7SPPl8etu7bBU+sxK37rGq"
    "KOpr2huPDOGdgwUneuykD8+egLvu/4tc2z4dFX9yZjT7EpEPqFq9gRR0aelCTwtvfxQVc2nnuEdfLBr3XMqXd6a2"
    "BvwA5zjScci/hat7Uq9LN+b5o5yfxMR5aSJ+SOJw6dj6hL9S2dPXiaji0OL7jGlBePavYF2NzkESbphIUeqnBFcp"
    "0BotvkJzFE2BEMIPhHRvQ9gD3/+OENBs9S1IgGw3q/jGIXT/fVFPOUQwzmDb+PFePk/FHNEexN9bK9YKJSebmMlB"
    "YswzzKiVqUPbSeXsugntVelFKg0aMVYoScO/DryCF1eG9bRCbnl2SmhstE7d3NDy7Vu7di1+0LxgTZL2kx8yO5KP"
    "OhQnUDtz1YgII82T+rrxwxJy+JypqZhU+7fI7m5zyB9JGiFVfkC4nY87Lv/pxgWKbqdyq4T6qgx+edrB7c68YPSU"
    "5NBoQifxjMnkI7rDcFwjR4ePRBYRhYS9ERX1lqgQHrbXCv9lKFLr2tPX7IQiWMGE63qTQpOrrakeWUMYJiq+U64Z"
    "6co7gthjQVdiNEVXqqWUky4ACZahkPfe8oZ2hi7lz07Mm6o71BoKT49m8nlcLvD5qR8FefSTQzf2DnkPnSvWqHt3"
    "f9Fgeo0c82NOzOkYOYI9aCO+QzKZW6HPItRe/ltcq3+4aPf83oFcd/g56I79Djrih9+FXRo1l7rjh/HIC/lLOCx7"
    "WOZw3ZEwYjp+tdl1h3DfqQz/BsLnKT7AXYpSc6J8j/6z8CreDM9zsX0HbNzYDj2IVci1S/zCwtzdTCYn3PpPURCi"
    "/9nfOuGMv7lx4zTRh5UuqtYpxFthYdQapDeZvEUS8Jpw4xL//cNCgKNs8HyU0c89uRdexbXIdm87EsPdQ6pzo0aR"
    "KdrGz/hdMMBkMgiQHNdOHJzMPV4CxwnfF8EbshlKaPppzA5u1gkwmROQg5+v4RUUPoMBg5fSt8Xb3JDD8hqt4nGF"
    "32X0JHG97rjQOXh1wZ/9w2kmuZmq6lhgR96OULMNJZeQgB/HUFuGR0NckDmap99EZftn0ZE8ms7A0veOkq/8Se+r"
    "ANfpzCmh7Ffyn1GUuu8V5eEEgCFoIpA/I/aKFkA0GpG80Rsa/afOrBNtNYfB1pnnG0tqIisamOsbTZzEF01YjHYy"
    "Zxr/ljwhKh/xr7g0NDqNmG6vqNwOxFMV9gqlQxqiA8LbyFGmJMGfhdeJniZ9pswp6EI6SdPlsZ1SVmmL0ND6X1L9"
    "bS4sGn2TUTVnlJLFvCzsO1rMzd5W0VmGQdsjMkdNhAnKVCYXpSaJXeCxLB02kDTlzmm5itwE5iVbqWEdqnyX5bcs"
    "UByn2NojjKcEjCaTnvm0a2QUEdSYnfhgwQjeCCziQBgsXJK+5JI8IWZ/5C40Z+0dFBoLl6Tnr1yS7dIl6YbwE2/h"
    "klTnLsl4cknukEsibLGtC82/YQZK5YO3pYukr+n/j9yoDQ7RqZOvr97RQwjpzM1DGdQuVNJOaG2DVFbNLFJ7ZJY3"
    "I0PP18z+CmEesj1toiVtgDT7bejXBQi748f1EmYjm7Ixm0RDHjf7sOXj3XyeCtmiY52b/eoxuM37B0qXxD3M9bfc"
    "k7+D26uELO9b8DVyHmboyiIDj49+CiVG5C5uSDyJdeH+xeNOCFibyhz5WZUs3/aHgXVaxxBjVTo3Fq5Wf6qdWbYF"
    "Cgc/BfcsyY/dJEH22fz8eSf2FGCR9BpWk398bCxlb52W88Y363oihnfk5lSeJPDyQR5zPQ4Qi1rhUTt9ACqELbrD"
    "lMEig9iMGSdRxe7lCdGA5R0um0JdIyJkOmeiWizlTfa8CrmZMPQ/TF6I6g27RS2EooGUNYw6gCoyKqrDbz77K2i/"
    "3c9IFp4n5chufb0aSaD/DqQfxJznx+ZDnrunycQ3oKKpAjlnMylkRj6uEitUEzVnhfxZ+JSQ4DYEYzDzRCd6mkMo"
    "kL846QDV1EM8Lqof80AI8z+SDyVngjLBTFGOS6irjCXl2lh5k/8EgB08ArVBejUrmP1EHn8tdfx+jLfiRPXIP7jM"
    "OTEWiZhCfeoHREg7E10n/2LIosRPYCmkTVANxAeID20iocCzWGek6CXzsECWLixwx1WYcR64VeEBuBfuWG9RRZgA"
    "FiS6PgUs7hWskKrjKh11dGO+kgvUFFsZRfIX3lQ6lffQz+BJelsg/ToulJMolp2AX8wwqqJNNGLcBmutEvjoIJwc"
    "IsP1BRhngiWgP5SelmEJ5RzRXPkQB77gSSU9VSdGcG9eherrUQQCRBpFxjUti3kNy+cZpLjzdL6Jc6izyeT2OmqW"
    "hmjmThMvoA69701xUqIX87hD/Xm481SNqm/mCmKsShsAHBSsFki+q/jVm4FHt08DZK9M3l2A43rRFB35Wj5lRss+"
    "5npwEK6vJar+i0ahDs/gOgQHlDFVJHeU5w3988HiVd4sOnWn8PLBVurv5qRqx/c61Ymc+hs60d/bnXJ0UfLHM0eQ"
    "ZzJ5xcn1OVh32vsI5/I2HNknGlgKqrgn6kcytSbcd+33QHG81VSM5hjAuypkl3B7BPMWQa7W8O/haw+Yyprk0LF8"
    "FfT0Y6rjDoaxroMHDx5KpXPxc0bUzdb/UbIts4/9bCJmY6wtbviPnCvroE+TwCMfL9JDa6fj6KllvG4HF2vNNbyu"
    "MmQJZeHcllkFM5ECtNZjrEYJ2EbRldEqUFkuU5TEVJ1V/wJvIextE4023UvkylBlPeLRYIMX6ukGpVAiAjJUvBFq"
    "a7uqztQo9QtEkajyx6/48i29zOxyD4ENfKmicNf6fT09w0y4VpsvBu7l/xt/DSYO1zWd/34l1SyaO4SJzZBt3iEo"
    "T3f5jjvfpvqA9otJwU8T1QdtUqnXF8IinMfQgO9abYtoMXe9gQ6nr8jvJfOGjmGqKrlQ/QZlm9xy71RSlMyz908A"
    "F5DDp5JhayZWmMjtZvVeIaoJ2xSg47+QbYpeTsqXI0ZemLtV0X7xtpQvt94h+94qmOShaud3K7L/BSawgL4="
)


@functools.lru_cache(maxsize=1)
def glyphs():
    """Character -> (coverage, x offset, y offset, advance)."""
    raw = zlib.decompress(base64.b64decode(_DATA))
    out, pos = {}, 0
    for code, (w, h, ox, oy, adv) in _INDEX.items():
        alpha = np.frombuffer(raw, np.uint8, w * h, pos).reshape(h, w)
        out[chr(code)] = (alpha, ox, oy, adv)
        pos += w * h
    return out
